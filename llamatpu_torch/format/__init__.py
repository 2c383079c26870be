"""Chat formats of the port (the Llama 3, Qwen2 and Phi-3 parts of
llamatpu/format)."""
from llamatpu_torch.format.chat_format import (ChatFormat, LlamaChatFormat, Message,
                                               Phi3ChatFormat, Role, build_chat_format)

__all__ = ["ChatFormat", "LlamaChatFormat", "Message", "Phi3ChatFormat", "Role",
           "build_chat_format"]
