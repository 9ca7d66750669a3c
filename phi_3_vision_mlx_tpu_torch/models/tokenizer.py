"""Tokenizers (counterpart of ``phi_3_vision_mlx_tpu/models/tokenizer.py``).

:func:`load_tokenizer` wraps the HF fast tokenizer of a local checkpoint
directory (``transformers`` is imported only then) and falls back to
:class:`ByteTokenizer`: a deterministic byte-level tokenizer with the Phi-3
special-token ids, so every flow runs without a downloaded file.  Its ids
and text are the JAX package's (``tests/test_torch_host.py``).
"""

from __future__ import annotations

import os
import re
from typing import List

SPECIAL_IDS = {
    "<|endoftext|>": 32000,
    "<|assistant|>": 32001,
    "<|placeholder1|>": 32002,
    "<|placeholder2|>": 32003,
    "<|placeholder3|>": 32004,
    "<|placeholder4|>": 32005,
    "<|system|>": 32006,
    "<|end|>": 32007,
    "<|placeholder5|>": 32008,
    "<|placeholder6|>": 32009,
    "<|user|>": 32010,
}
ID_BOS = 1
ID_PAD = 0
_BYTE_BASE = 1000  # byte b -> id 1000 + b
_SPECIAL_RE = re.compile("(" + "|".join(re.escape(s) for s in SPECIAL_IDS) + ")")
_ID_TO_SPECIAL = {v: k for k, v in SPECIAL_IDS.items()}


class _Batch(dict):
    @property
    def input_ids(self):
        return self["input_ids"]


class ByteTokenizer:
    """Hermetic byte-level tokenizer with Phi-3 special-token ids."""

    vocab_size = 32064
    eos_token_id = SPECIAL_IDS["<|end|>"]
    bos_token_id = ID_BOS
    pad_token_id = ID_PAD

    def __call__(self, texts, **kw):
        if isinstance(texts, str):
            return _Batch(input_ids=self.encode(texts))
        return _Batch(input_ids=[self.encode(t) for t in texts])

    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]:
        ids = [ID_BOS] if add_special_tokens else []
        for part in _SPECIAL_RE.split(text):
            if not part:
                continue
            if part in SPECIAL_IDS:
                ids.append(SPECIAL_IDS[part])
            else:
                ids.extend(_BYTE_BASE + b for b in part.encode("utf-8"))
        return ids

    def decode(self, ids, skip_special_tokens: bool = False) -> str:
        out: List[bytes] = []
        for i in ids:
            i = int(i)
            if i in (ID_BOS, ID_PAD):
                continue
            if i in _ID_TO_SPECIAL:
                if not skip_special_tokens:
                    out.append(_ID_TO_SPECIAL[i].encode())
            elif _BYTE_BASE <= i < _BYTE_BASE + 256:
                out.append(bytes([i - _BYTE_BASE]))
            else:
                # Any other id (random weights emit them) renders visibly, so
                # that equal text means equal token streams.
                out.append(f"<{i}>".encode())
        return b"".join(out).decode("utf-8", errors="replace")

    def batch_decode(self, batch, **kw):
        return [self.decode(ids, **kw) for ids in batch]


def load_tokenizer(local_dir: str):
    """HF tokenizer from a checkpoint dir, ByteTokenizer when unavailable."""
    try:
        files = set(os.listdir(local_dir)) if os.path.isdir(local_dir) else set()
    except OSError:
        files = set()
    if {"tokenizer.json", "tokenizer.model"} & files:
        try:
            from transformers import AutoTokenizer

            return AutoTokenizer.from_pretrained(local_dir)
        except Exception:  # no transformers, or an unreadable tokenizer: bytes
            pass
    return ByteTokenizer()
