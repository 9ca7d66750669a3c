"""Prompt processors (counterpart of
``phi_3_vision_mlx_tpu/models/preprocess.py``), numpy only.

:class:`Phi3Processor` tokenizes a single prompt straight and a batch
**left-padded** with id 0, per-row position ids restarting at 0 (pads get
pid 1) and a 0/1 mask of the real tokens — the batch path that batched
admission (``engine/batching.py:prepare_many``) runs.

:class:`Phi3VProcessor` is the vision path: it splits the prompt on the
``<|image_N|>`` tags, puts a run of ``num_img_tokens[N - 1]`` placeholder
ids ``-N`` in place of each tag, and returns the placeholders' positions
(an argwhere of the negative ids) beside the image processor's output.
Vision prompts are one row, as in the JAX package.
"""

from __future__ import annotations

import os
import re
from typing import List, Optional

import numpy as np

from .tokenizer import load_tokenizer

_IMG_TAG = re.compile(r"<\|image_\d+\|>")


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
        super().__init__(local_dir, tokenizer)
        from .image_processor import Phi3VImageProcessor

        self.img_processor = Phi3VImageProcessor()

    def __call__(self, texts, images=None):
        if images is None:
            return self._tokenize(texts)
        raw = os.environ.get("PHI3V_TPU_DEVICE_IMAGE", "1") == "1"
        return self._merge(self.img_processor(images, raw=raw), texts)

    def _merge(self, images: dict, texts: str) -> dict:
        prompt_chunks = self.tokenizer(re.split(_IMG_TAG, texts)).input_ids
        num_img_tokens = images["num_img_tokens"]
        image_ids = [int(tag.split("|")[1].split("_")[-1]) for tag in re.findall(_IMG_TAG, texts)]
        image_ids_pad = [[-iid] * num_img_tokens[iid - 1] for iid in image_ids]
        if len(prompt_chunks) > len(image_ids_pad):
            image_ids_pad = image_ids_pad + [[]]
        input_ids: List[int] = []
        for chunk, pad in zip(prompt_chunks, image_ids_pad):
            input_ids.extend(chunk)
            input_ids.extend(pad)
        input_ids = np.array(input_ids, np.int32)[None]
        out = {
            "input_ids": input_ids,
            "image_sizes": np.asarray(images["image_sizes"], np.int32),
            "positions": np.argwhere(input_ids < 0).astype(np.int32),
        }
        if "raw_images" in images:
            out["raw_images"] = images["raw_images"]
            out["resize_plans"] = images["resize_plans"]
        elif "hd_images" in images:
            out["hd_images"] = images["hd_images"]
        else:
            out["pixel_values"] = np.asarray(images["pixel_values"], np.float32)
        return out
