"""Chat formats of the port (the Llama 3 part of llamatpu/format)."""
from llamatpu_torch.format.chat_format import (ChatFormat, LlamaChatFormat, Message, Role,
                                               build_chat_format)

__all__ = ["ChatFormat", "LlamaChatFormat", "Message", "Role", "build_chat_format"]
