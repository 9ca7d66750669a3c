"""Prompt processors (counterpart of
``phi_3_vision_mlx_tpu/models/preprocess.py``), numpy only.

:class:`Phi3Processor` tokenizes a single prompt straight and a batch
**left-padded** with id 0, per-row position ids restarting at 0 (pads get
pid 1) and a 0/1 mask of the real tokens — the batch path that batched
admission (``engine/batching.py:prepare_many``) runs.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from .tokenizer import load_tokenizer


class Phi3Processor:
    def __init__(self, local_dir: Optional[str] = None, tokenizer=None):
        self.tokenizer = tokenizer if tokenizer is not None else load_tokenizer(local_dir or "")

    def _tokenize(self, texts):
        if isinstance(texts, str):
            return {"input_ids": np.array(self.tokenizer(texts).input_ids)[None]}
        input_ids: List[List[int]] = self.tokenizer(texts).input_ids
        width = max(len(row) for row in input_ids)
        pads = [width - len(row) for row in input_ids]
        return {
            "input_ids": np.array([[0] * p + row for p, row in zip(pads, input_ids)], np.int32),
            "pids": np.array([[1] * p + list(range(len(row))) for p, row in zip(pads, input_ids)],
                             np.int32),
            "mask": np.array([[0] * p + [1] * len(row) for p, row in zip(pads, input_ids)], np.int32),
        }

    def __call__(self, texts, images=None):
        if images is not None:
            print("WARNING: You are using phi3_mini_128k. Use phi3_v for VLM tasks.")
        return self._tokenize(texts)


class Phi3VProcessor(Phi3Processor):
    def __init__(self, local_dir: Optional[str] = None, tokenizer=None):
        raise NotImplementedError("vision is not ported yet")
