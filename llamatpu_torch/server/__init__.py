"""The OpenAI-compatible server of the port (llamatpu/server)."""
