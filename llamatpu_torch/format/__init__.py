"""Chat formats of the port (llamatpu/format), all nine families."""
from llamatpu_torch.format.chat_format import (ChatFormat, DevstralChatFormat, GraniteChatFormat,
                                               LlamaChatFormat, Message, MistralChatFormat,
                                               Phi3ChatFormat, QwenChatFormat, Role,
                                               build_chat_format)

__all__ = ["ChatFormat", "DevstralChatFormat", "GraniteChatFormat", "LlamaChatFormat", "Message",
           "MistralChatFormat", "Phi3ChatFormat", "QwenChatFormat", "Role", "build_chat_format"]
