"""AdamW on device tensors (the port's counterpart of ``optax.adamw``
under ``optax.inject_hyperparams``, as the JAX trainer and ``pretrain``
use it): weight decay 0.01, betas (0.9, 0.999), eps 1e-8 by default.

A training step on the card is one replay of a CUDA graph
(``engine/graphs.py``), so the update may read no host value that changes
between steps: the rate and the step count are device tensors,
and the moments are allocated with the optimizer, before any step (a
capture's warm-up step must find them).  ``torch.optim.AdamW`` cannot serve
both devices here: its graph-safe mode (``capturable=True``) refuses CPU
tensors, and its CPU mode reads the step count on the host.  So the update
is plain tensor ops that run alike on the CPU and the card, in the order
of ``torch.optim.AdamW``'s single-tensor update:

    count += 1;  p *= 1 - lr * wd;  m = lerp(m, g, 1 - b1);
    v = b2 * v + (1 - b2) * g * g;
    p -= m / (sqrt(v) / sqrt(1 - b2 ** count) + eps) * lr / (1 - b1 ** count)

(the capturable mode's folded form, ``m / (sqrt(v) / (c * -s) + eps /
-s)``, divides by zero at a rate of 0, the first step of a warmup).  It is
``optax.adamw``'s update in another order of rounding (optax scales ``m /
(1 - b1^t) / (sqrt(v / (1 - b2^t)) + eps) + wd * p`` by ``-lr``).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch


class AdamW:
    """AdamW over ``params`` (tensors updated in place): ``count`` (1,) f32
    the steps taken, ``exp_avg`` / ``exp_avg_sq`` the moments, one a param.
    Each :meth:`step` takes its rate as a (1,) f32 device tensor (a training
    step's static input, as ``optax.inject_hyperparams`` sets the rate of
    each step)."""

    def __init__(self, params: Sequence[torch.Tensor], betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.01):
        self.params = list(params)
        self.betas, self.eps, self.weight_decay = (float(betas[0]), float(betas[1])), float(eps), float(
            weight_decay)
        self.count = torch.zeros((1,), dtype=torch.float32, device=self.params[0].device)
        self.exp_avg = [torch.zeros_like(p) for p in self.params]
        self.exp_avg_sq = [torch.zeros_like(p) for p in self.params]

    def state_tensors(self) -> List[torch.Tensor]:
        """Every tensor a step advances besides the params: the count and
        the moments (a graph's ``save``)."""
        return [self.count, *self.exp_avg, *self.exp_avg_sq]

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor], lr: torch.Tensor) -> None:
        """One update of every param from its gradient, at rate ``lr``."""
        b1, b2 = self.betas
        self.count += 1
        step_size = lr / (1 - b1 ** self.count)
        bc2_sqrt = (1 - b2 ** self.count).sqrt()
        decay = 1 - lr * self.weight_decay
        for p, g, m, v in zip(self.params, grads, self.exp_avg, self.exp_avg_sq, strict=True):
            p.mul_(decay)
            m.lerp_(g, 1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            p.sub_(m / (v.sqrt() / bc2_sqrt).add_(self.eps) * step_size)

    def state_dict(self) -> Dict[str, object]:
        return {"count": self.count.detach().cpu().clone(), "exp_avg": [t.detach().cpu().clone() for t in self.exp_avg],
                "exp_avg_sq": [t.detach().cpu().clone() for t in self.exp_avg_sq]}

    @torch.no_grad()
    def load_state_dict(self, state: Dict[str, object]) -> None:
        """Copy a :meth:`state_dict` into this optimizer's tensors (their
        addresses stay: a captured step keeps reading them)."""
        self.count.copy_(state["count"])
        for dst, src in zip(self.exp_avg + self.exp_avg_sq, list(state["exp_avg"]) + list(state["exp_avg_sq"]),
                            strict=True):
            dst.copy_(src)
