"""Adversarial tokenizer round-trip corpus (the port's copy of
llamatpu/tokenizer/adversarial.py): emoji/ZWJ clusters, CJK, combining marks,
digit runs, contraction casing, control bytes, astral-plane codepoints. Run
by the port's `validate` command (bench/validate.py) and its tests.
"""

ADVERSARIAL_TEXTS = [
    "hello world",
    "👩‍👩‍👧‍👦 family 👨🏽‍🚀 astronaut 🏳️‍🌈",          # ZWJ + skin tone + VS16
    "é combining å ring ñ",            # combining marks
    "日本語のテキスト中文文本한국어 텍스트",
    "мир — мир, ωορλδ",
    "1234 12345 1,234.56 ١٢٣ ४५६",                       # digit runs + non-ASCII digits
    "DON'T can'T I'LL they'RE we'Ve he'S it'D",          # contraction casing
    "don't i'll we've",                                   # lowercase contractions
    "  leading spaces\tand\ttabs\n\nnewlines\r\nCRLF  ",
    "a" * 300 + " " + "b" * 7,                            # long single-word chunk
    "\x00null\x01bytes\x7f",
    "mixed 🎉日本 text123abc!@#  nbsp emsp",
    "...!!!???;;;:::---===+++",
    " line para separators",
    "𝔘𝔫𝔦𝔠𝔬𝔡𝔢 𝕄𝕒𝕥𝕙 🜁🜂🜃",                              # astral plane
]
