"""Prompt ids as the served system forms them, written out plainly.

The served configuration has no tokenizer files, so it runs a byte-level
stand-in with the Phi-3 special ids (listed as assumed in each
configuration file): BOS (1) opens the text, each UTF-8 byte ``b`` is id
``1000 + b``, the special tokens below are single ids.  A vision prompt is
split at its ``<|image_N|>`` tags; each piece is encoded on its own (BOS
included, as the MLX framework the system follows does; Hugging Face's
processor drops the later pieces' BOS) and each tag becomes a run of
``-N`` placeholder ids as long as the image's token count.
"""

from __future__ import annotations

import re

SPECIAL = {
    "<|endoftext|>": 32000, "<|assistant|>": 32001, "<|placeholder1|>": 32002,
    "<|placeholder2|>": 32003, "<|placeholder3|>": 32004, "<|placeholder4|>": 32005,
    "<|system|>": 32006, "<|end|>": 32007, "<|placeholder5|>": 32008,
    "<|placeholder6|>": 32009, "<|user|>": 32010,
}
BOS = 1
IMAGE_TAG = re.compile(r"<\|image_(\d+)\|>")
_SPLIT = re.compile("(" + "|".join(re.escape(s) for s in SPECIAL) + ")")


def encode(text: str) -> list:
    ids = [BOS]
    for part in _SPLIT.split(text):
        if part in SPECIAL:
            ids.append(SPECIAL[part])
        elif part:
            ids.extend(1000 + b for b in part.encode("utf-8"))
    return ids


def prompt_ids(text: str, image_tokens=()) -> list:
    """The ids of ``text``; ``image_tokens[N - 1]``: placeholders of the
    N-th image."""
    pieces = IMAGE_TAG.split(text)  # text, N, text, N, ...
    ids = encode(pieces[0])
    for j in range(1, len(pieces), 2):
        n = int(pieces[j])
        ids.extend([-n] * image_tokens[n - 1])
        ids.extend(encode(pieces[j + 1]))
    return ids
