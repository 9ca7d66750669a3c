"""Host-side streaming and stop criteria (counterpart of
``phi_3_vision_mlx_tpu/engine/stream.py``), numpy only.

The device returns a chunk of tokens plus per-step logit statistics, and
these classes consume them one step at a time on the host, in the JAX
package's order (``tests/test_torch_host.py`` holds them to it).
"""

from __future__ import annotations

import math
from typing import List

import numpy as np

from ..core.config import ID_EOS


class Streamer:
    """Incremental detokenizer.

    Stream mode (B = 1) prints up to the last space as tokens arrive; batch
    mode collects tokens, cuts each row after its first EOS and decodes the
    batch.  With ``stops`` the printer withholds ``len(longest stop) - 1``
    characters and never prints at or past a stop, so the streamed text
    equals the trimmed return value.
    """

    def __init__(self, tokenizer, stream: bool, mute: bool, stops=None):
        self.tokenizer = tokenizer
        self.mute = mute
        self.stream = stream and (not mute)
        self.stops = [stops] if isinstance(stops, str) else list(stops or [])
        self.holdback = max((len(s) for s in self.stops), default=1) - 1
        self.list_tokens: List = []
        self.idx_sofar = 0

    def _print_limit(self, txt: str) -> int:
        """Highest index into ``txt`` safe to print through (exclusive)."""
        limit = len(txt) - self.holdback
        cuts = [txt.find(s) for s in self.stops if s in txt]
        if cuts:
            limit = min(limit, min(cuts))
        return max(limit, 0)

    def _trim(self, txt: str) -> str:
        cuts = [txt.find(s) for s in self.stops if s in txt]
        return txt[: min(cuts)] if cuts else txt

    def __call__(self, token: np.ndarray):
        """token: (B, 1) numpy int array."""
        if not self.stream:
            self.list_tokens.append(token)
            return
        if token.shape[0] > 1:
            self.list_tokens.append(token)
            self.stream = False
            return
        self.list_tokens.append(int(token[0, 0]))
        txt = self.tokenizer.decode(self.list_tokens)
        idx_split = txt.rfind(" ", self.idx_sofar, self._print_limit(txt))
        if idx_split > 0:
            print(txt[self.idx_sofar : idx_split], end="", flush=True)
            self.idx_sofar = idx_split

    def end(self):
        if self.stream:
            txt = self.tokenizer.decode(self.list_tokens)
            print(self._trim(txt)[self.idx_sofar :], "\n", flush=True)
            return txt, len(self.list_tokens)
        arr = np.concatenate(self.list_tokens, axis=1)
        rows = [r[: r.index(ID_EOS) + 1] if ID_EOS in r else r for r in arr.tolist()]
        list_txt = self.tokenizer.batch_decode(rows)
        if not self.mute:
            for i, gen in enumerate(list_txt):
                print(f"\n< Generated text for prompt #{i} >\n{self._trim(gen)}")
        return list_txt, arr.size


def validate_stops(stop) -> List[str]:
    """A user's ``stop`` (None, a non-empty str, or a list/tuple of at most
    16 non-empty str) as a list; anything else raises ``ValueError``."""
    if stop is None:
        return []
    if isinstance(stop, str):
        stop = [stop]
    if not isinstance(stop, (list, tuple)):
        raise ValueError(f"stop must be a string or a list of strings, got {type(stop).__name__}")
    if len(stop) > 16:
        raise ValueError(f"at most 16 stop sequences supported, got {len(stop)}")
    for s in stop:
        if not isinstance(s, str) or not s:
            raise ValueError(f"stop entries must be non-empty strings, got {s!r}")
    return list(stop)


def stop_tail_window(stops) -> int:
    """Token tail long enough to find any of ``stops`` in decoded text: a
    stop of L characters spans at most about L tokens, plus 16 of margin."""
    return max((len(s) for s in stops), default=0) + 16


class StopSequences:
    """Stop-string matching over decoded text (a stop spanning token
    boundaries still fires).  ``update`` takes one token per row and returns
    True once every row has matched; ``trim`` cuts each text at its earliest
    stop.  Only a token tail (:func:`stop_tail_window`) is decoded."""

    def __init__(self, tokenizer, stops, batch_size: int):
        self.stops = validate_stops(stops)
        self.tokenizer = tokenizer
        self.ids: List[List[int]] = [[] for _ in range(batch_size)]
        self.hit = np.zeros(batch_size, bool)
        self._tail = stop_tail_window(self.stops)

    def __bool__(self):
        return bool(self.stops)

    def update(self, token: np.ndarray) -> bool:
        """token: (B,) or (B, 1) latest token per row."""
        if not self.stops:
            return False
        for r, t in enumerate(np.asarray(token).reshape(-1).tolist()):
            if self.hit[r]:
                continue
            self.ids[r].append(int(t))
            txt = self.tokenizer.decode(self.ids[r][-self._tail :])
            if any(s in txt for s in self.stops):
                self.hit[r] = True
        return bool(self.hit.all())

    def trim_text(self, text: str) -> str:
        cuts = [text.find(s) for s in self.stops if s in text]
        return text[: min(cuts)] if cuts else text

    def trim(self, result):
        if not self.stops:
            return result
        if isinstance(result, str):
            return self.trim_text(result)
        return [self.trim_text(t) for t in result]


class LogitStopper:
    """Early stop (B = 1 only): stop once the log-prob mass accrued since the
    best EOS score so far falls below that score.  Takes per-step scalars:
    the max log-softmax and the log-softmax at EOS."""

    def __init__(self, max_tokens: int, early_stop):
        self.step = 0
        self.early_stop = (
            early_stop if isinstance(early_stop, int) and early_stop < max_tokens else False
        )
        self.log_prob_sum = 0.0
        self.best_eos_sofar = -math.inf
        self.log_prob_sum_at_best_eos = 0.0

    def update(self, log_prob_best: float, log_prob_eos: float, batch: int) -> bool:
        if not self.early_stop:
            return False
        if batch > 1:
            self.early_stop = False
            return False
        if log_prob_eos > self.best_eos_sofar:
            since_best = self.log_prob_sum - self.log_prob_sum_at_best_eos
            if (since_best < self.best_eos_sofar) and (self.step > self.early_stop):
                return True
            self.best_eos_sofar = log_prob_eos
            self.log_prob_sum_at_best_eos = self.log_prob_sum
        self.log_prob_sum += log_prob_best
        self.step += 1
        return False


class TokenStopper:
    """Stop when every row of the batch has emitted EOS."""

    def __init__(self, batch_size: int, eos_id: int = ID_EOS):
        self.eos_id = eos_id
        self.eos_rows = np.ones(batch_size, bool)

    def update(self, token: np.ndarray) -> bool:
        """token: (B,) or (B, 1)."""
        self.eos_rows &= np.asarray(token).reshape(-1) != self.eos_id
        return not self.eos_rows.any()
