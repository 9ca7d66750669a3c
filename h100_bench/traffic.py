"""The one traffic generator: a traffic file's parameters and a seed in,
requests out.  No traffic needs code of its own.

Sizes are stratified so that the seed changes the order of the work and
not its amount: each length distribution is cut into ``block`` strata at
the quantiles ``(k + 0.5) / block``, and the strata are paired into
``block`` request shapes (prompt, output and image) by a fixed pairing
that no seed changes.  Each block of ``block`` consecutive requests holds
every shape once, in an order drawn from the seed, so any run of requests
carries nearly the same work whatever the seed.  Text and pixels come from
the seed and the request's index.

A traffic file (JSON) holds:

* ``server``: ``slots``, ``window``, ``page_size`` of the paged engine;
* ``clients``: closed-loop clients, each sending its next request when
  the last returns;
* ``ramp_seconds``: load before the window opens; ``trace_seconds``: the
  profiled stretch of a traced run, right after its window;
* ``block``: strata a block; ``prompt_tokens`` and ``max_tokens``:
  ``{"dist": "lognormal", "median", "sigma", "min", "max"}`` or
  ``{"dist": "uniform", "min", "max"}`` (prompt tokens count the chat
  template; with images, the question's text tokens);
* ``images`` (optional): ``{"shapes": [[h, w], ...]}``, one image a
  request, each shape on an equal share of a block's requests.
"""

from __future__ import annotations

import math
from statistics import NormalDist

import numpy as np

CHAT_TURN = "<|user|>\n{body}<|end|>\n<|assistant|>\n"
TEMPLATE_TOKENS = 7  # BOS, <|user|>, \n, <|end|>, \n, <|assistant|>, \n
ALPHABET = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz     ,.", np.uint8)
STREAMS = {"order": 1, "text": 2, "pixels": 3, "warm": 4, "sample": 5}


def rng(seed: int, stream: str, index: int) -> np.random.Generator:
    """An independent generator for (seed, stream, index); any seed that
    fits in 64 bits."""
    return np.random.default_rng([int(seed) & (2**64 - 1), STREAMS[stream], int(index)])


def strata(dist: dict, block: int) -> np.ndarray:
    """The ``block`` stratum values of a length distribution, ascending."""
    q = (np.arange(block) + 0.5) / block
    if dist["dist"] == "lognormal":
        z = np.array([NormalDist().inv_cdf(float(x)) for x in q])
        v = dist["median"] * np.exp(dist["sigma"] * z)
    elif dist["dist"] == "uniform":
        v = dist["min"] + q * (dist["max"] - dist["min"])
    else:
        raise ValueError(f"unknown length distribution {dist['dist']!r}")
    return np.clip(np.rint(v), dist["min"], dist["max"]).astype(np.int64)


class Traffic:
    """Request ``i`` of a traffic file under a seed: a dict with ``prompt``
    (the chat-templated text), ``max_tokens``, and with images ``image``
    (h, w) and ``question``."""

    def __init__(self, params: dict, seed: int):
        self.params, self.seed = params, int(seed)
        self.block = int(params["block"])
        self.prompt_strata = strata(params["prompt_tokens"], self.block)
        self.output_strata = strata(params["max_tokens"], self.block)
        self.images = params.get("images")
        # The fixed pairing of strata into request shapes (no seed moves it).
        self.pairing = np.random.default_rng(0).permutation(self.block)

    def shape(self, i: int) -> int:
        """The request shape (0 .. block - 1) of request ``i``."""
        b, k = divmod(int(i), self.block)
        return int(rng(self.seed, "order", b).permutation(self.block)[k])

    def sizes(self, i: int) -> tuple:
        """(prompt tokens, max_tokens) of request ``i``."""
        j = self.shape(i)
        return int(self.prompt_strata[j]), int(self.output_strata[self.pairing[j]])

    def text(self, i: int, n: int) -> str:
        """``n`` bytes of seeded text (one token a byte under the byte
        tokenizer)."""
        return ALPHABET[rng(self.seed, "text", i).integers(0, len(ALPHABET), n)].tobytes().decode()

    def request(self, i: int) -> dict:
        n_prompt, n_out = self.sizes(i)
        if not self.images:
            return {"index": i, "prompt": CHAT_TURN.format(body=self.text(i, n_prompt - TEMPLATE_TOKENS)),
                    "max_tokens": n_out, "image": None}
        shapes = self.images["shapes"]
        question = self.text(i, n_prompt)
        return {"index": i, "prompt": CHAT_TURN.format(body=f"<|image_1|>\n{question}"),
                "max_tokens": n_out, "image": tuple(shapes[self.shape(i) % len(shapes)]),
                "question": question}

    def pixels(self, i: int, shape) -> np.ndarray:
        """The seeded (h, w, 3) uint8 image of request ``i``."""
        h, w = shape
        g = rng(self.seed, "pixels", i) if i >= 0 else rng(self.seed, "warm", 1000 - i)
        return g.integers(0, 256, (h, w, 3), dtype=np.uint8)

    def warm_up(self) -> list:
        """Requests that take every shape the window can: the largest
        prompt and each image shape, with short outputs (a prefill bucket
        is never compiled, but its first run sizes the allocator)."""
        top, short = int(self.prompt_strata.max()), int(self.output_strata.min())

        def text(j, n):
            return ALPHABET[rng(self.seed, "warm", j).integers(0, len(ALPHABET), n)].tobytes().decode()

        if self.images:
            return [{"index": -1 - j, "prompt": CHAT_TURN.format(body=f"<|image_1|>\n{text(j, top)}"),
                     "max_tokens": short, "image": tuple(shape)}
                    for j, shape in enumerate(self.images["shapes"])]
        return [{"index": -1 - j, "prompt": CHAT_TURN.format(body=text(j, top - TEMPLATE_TOKENS)),
                 "max_tokens": short, "image": None}
                for j in range(int(self.params["server"]["slots"]))]


def p90(latencies) -> float:
    """The 90th percentile by nearest rank; a request that never finished
    reads as infinity and sorts last."""
    xs = sorted(latencies)
    return xs[max(0, math.ceil(0.9 * len(xs)) - 1)] if xs else math.inf
