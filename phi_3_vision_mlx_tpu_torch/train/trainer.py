"""LoRA training and evaluation (counterpart of
``phi_3_vision_mlx_tpu/train/trainer.py``; the reference's ``train_lora``,
``test_lora`` and ``TrainingCallback``).

The JAX package's semantics carry over:

* the data pipeline: question rows -> ``<|user|>Q<|end|><|assistant|>S<|end|>``
  prompts, left-padded batches in a 64-token bucket, per-epoch shuffled
  index chunks, one ``random.Random`` stream a batch drawn up front;
* the optional attention-mask dropout (``mask_ratios``): each row repeated
  per ratio with random maskable positions zeroed, its loss scaled
  ``10 ** (-10 * ratio)``;
* the loss: causal cross-entropy over the tokens after ``<|assistant|>``
  (``ID_ASS``), logits in float32, the mean of each row, their scaled sum;
* the schedule (linear warmup, then linear decay), AdamW with weight decay
  0.01, the learning rate of each step set before it (as ``optax.
  inject_hyperparams`` does), the gradients of inactive layers zeroed, and
  best-average-loss adapters in the reference's files.

The inactive layers' LoRA leaves enter the loss detached
(``train/lora.py:active_layers``): the same loss and kept gradients, and a
backward that stops at the lowest active layer.

A step (:func:`lora_step`) is the loss over ``forward_nocache(allow_flash=
False)`` (``models/phi3.py``), its gradients (``torch.autograd.grad``), the
gradient mask and the AdamW update (``train/adamw.py``), all on device
tensors: on the card the base's linears run K1 / K8 / K9 up to 256 rows and
the dequantize route above, each behind the autograd seam of
``ops/kernels/quant_matmul.py``, and the LoRA leaves, the AdamW state and
the loss are float32 over a bf16 base.  As the JAX trainer compiles its
step once a batch shape, ``train_lora`` keeps a static step a (rows,
bucketed length) (``engine/graphs.py:StaticStep``: the batch, its RoPE
tables, the rate and the dropout key copied into static inputs, the loss
its static output): with ``lm.graphs`` (the card's default) each is a CUDA
graph, captured at its first batch and replayed after, the graphs of a run
in one memory pool; ``LM(graphs=False)``, and the CPU, run the same step
eagerly (the reference).  A capture or a replay that fails raises.  The
dropout mask is keyed on the step's device key (``phi3.lora_dropout_mask``).
``train_lora`` and ``test_lora`` run on ``device`` (the card unless the
caller names another).  Mid-run resume saves ``torch.save`` states
(``train/checkpoint.py``).
"""

from __future__ import annotations

import json
import math
import os
import random
import time
from typing import List, Optional

import numpy as np
import torch

from ..core import weights as W
from ..core.config import ID_ASS
from ..engine.engine import round_up
from ..engine.graphs import StaticStep
from ..models import phi3
from ..ops.rope import su_rope_tables
from .adamw import AdamW
from .data import load_qa_dataset
from .lora import (active_layers, adapter_flat_dict, inject_lora, lora_leaves, mask_lora_grads, merge_lora,
                   partition_lora)


class TrainingCallback:
    """Loss logging and best-checkpoint saving (reference phi.py:26-82)."""

    def __init__(self, lora_cfg, lr_schedule, batch_indices, sum_every=3):
        self.batch_indices = batch_indices
        self.lora_cfg = lora_cfg
        self.adapter_path = lora_cfg["adapter_path"]
        self.lr_schedule = lr_schedule
        self.sum_every = min(sum_every, len(batch_indices))
        self.current_step = 0
        self.sum_loss = 0.0
        self.best_loss = math.inf
        self.train_log = {"step_i": [], "step_loss": [], "avg_i": [], "avg_loss": []}
        self.start_time = time.perf_counter()
        os.makedirs(self.adapter_path, exist_ok=True)
        self._save_adapter = None  # bound by train_lora
        self.steps = {}  # the run's static steps by (rows, length), bound by train_lora

    def __call__(self, step_loss: float):
        self.current_step += 1
        print(f"- Step loss at step {self.current_step}: {step_loss:.2f}")
        self.train_log["step_i"].append(self.current_step)
        self.train_log["step_loss"].append(step_loss)
        self.sum_loss += step_loss
        if self.current_step % self.sum_every == 0:
            avg_loss = self.sum_loss / self.sum_every
            self.sum_loss = 0.0
            self.train_log["avg_i"].append(self.current_step)
            self.train_log["avg_loss"].append(avg_loss)
            print(f"Avg loss at step {self.current_step}: {avg_loss:.2f}")
            if avg_loss < self.best_loss and self._save_adapter is not None:
                self.best_loss = avg_loss
                self._save_adapter()

    def end_log(self):
        train_log = self.train_log
        train_log["train_time"] = time.perf_counter() - self.start_time
        with open(f"{self.adapter_path}/adapter_config.json", "w") as f:
            json.dump(self.lora_cfg, f, indent=4)
        with open(f"{self.adapter_path}/adapter_train_log.json", "w") as f:
            json.dump(train_log, f, indent=4)
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            fig, (ax1, ax2, ax3) = plt.subplots(3, 1)
            ax1.plot(
                train_log["step_i"], train_log["step_loss"],
                color="b", alpha=0.5, label="Step Loss",
            )
            ax1.plot(train_log["avg_i"], train_log["avg_loss"], color="r", label="Avg Loss")
            ax1.set_title("Training Loss Curves")
            ax1.legend()
            ax2.plot(np.asarray(self.lr_schedule))
            ax2.ticklabel_format(axis="y", style="sci")
            ax2.set_title("Learning Rate Schedule")
            batch_numbers = np.arange(len(self.batch_indices))
            x = np.repeat(batch_numbers, [len(s) for s in self.batch_indices])
            y = np.concatenate([np.asarray(s) for s in self.batch_indices])
            ax3.scatter(x, y, color="b", marker=".", alpha=0.5)
            ax3.set_title("Batch Indices")
            plt.tight_layout()
            fig.savefig(
                f"train_log_{self.current_step}_steps_in_"
                f"{train_log['train_time']:.0f}_sec.png"
            )
            plt.close(fig)
        except Exception as e:  # plotting must never kill a training run
            print(f"(training plot skipped: {e})")
        print(f"Training log saved to {self.adapter_path}")
        print(f"Total training time: {train_log['train_time']:.2f} seconds")


def _get_lr_schedule(lr: float, steps: int, warmup: float) -> np.ndarray:
    """Linear warmup -> linear decay (reference :1014-1016)."""
    n_warmup = int(steps * warmup)
    return np.concatenate(
        [np.linspace(1e-6, lr, n_warmup), np.linspace(lr, 1e-6, steps - n_warmup + 1)[1:]]
    ).astype(np.float32)


def _prompt_rows(rows) -> List[str]:
    """Dataset rows -> training prompts (reference ``_prompt``, :950-955)."""
    prompts = []
    for r in rows:
        q = r["input"].rsplit(" A: ", 1)[0].strip()
        s = r["summary"].strip().split("\n", 1)[0].strip()
        prompts.append(f"<|user|>\n{q}<|end|>\n<|assistant|>\n{s}<|end|>")
    return prompts


def _mask_augment(batch: dict, mask_ratios, rng: random.Random):
    """Attention-mask-dropout augmentation (reference ``_mask``, :956-983)."""
    if mask_ratios is None:
        return batch, np.ones(len(batch["input_ids"]), np.float32)
    new_batch = {k: [] for k in batch}
    num_versions = len(mask_ratios) + 1
    loss_scales = []
    for key in batch:
        if key != "mask":
            new_batch[key] = [seq for seq in batch[key] for _ in range(num_versions)]
    for i in range(len(batch["input_ids"])):
        input_tokens = list(batch["input_ids"][i])
        original_mask = list(batch["mask"][i])
        new_batch["mask"].append(original_mask)
        loss_scales.append(1.0)
        start = max((j for j, t in enumerate(input_tokens) if t < 0), default=0) + 3
        end = (
            input_tokens.index(ID_ASS) - 3
            if ID_ASS in input_tokens
            else len(input_tokens)
        )
        maskable = [j for j in range(start, end) if original_mask[j] == 1]
        for ratio in mask_ratios:
            masked = original_mask.copy()
            for idx in rng.sample(maskable, int(len(maskable) * ratio)):
                masked[idx] = 0
            new_batch["mask"].append(masked)
            loss_scales.append(10.0 ** (-10.0 * ratio))
    return new_batch, np.asarray(loss_scales, np.float32)


def _prepare_batch(processor, prompts: List[str], mask_ratios, rng, bucket: int = 64):
    """Tokenize, augment and left-pad to a multiple of ``bucket`` (numpy)."""
    batch = processor(prompts)
    batch = {k: np.asarray(v).tolist() for k, v in batch.items()}
    if "pids" not in batch:
        l = len(batch["input_ids"][0])
        batch["pids"] = [list(range(l)) for _ in batch["input_ids"]]
        batch["mask"] = [[1] * l for _ in batch["input_ids"]]
    batch, loss_scales = _mask_augment(batch, mask_ratios, rng)
    ids = np.asarray(batch["input_ids"], np.int32)
    pids = np.asarray(batch["pids"], np.int32)
    mask = np.asarray(batch["mask"], np.int32)
    b, l = ids.shape
    l_pad = max(round_up(l, bucket), bucket)
    pad = l_pad - l
    if pad:
        ids = np.concatenate([np.zeros((b, pad), np.int32), ids], axis=1)
        pids = np.concatenate([np.ones((b, pad), np.int32), pids], axis=1)
        mask = np.concatenate([np.zeros((b, pad), np.int32), mask], axis=1)
    splits = np.asarray(
        [row.tolist().index(ID_ASS) if ID_ASS in row else l_pad - 1 for row in ids],
        np.int32,
    )
    targets = ids[:, 1:]
    loss_masks = (np.arange(targets.shape[1])[None, :] >= splits[:, None]).astype(
        np.float32
    ) * mask[:, 1:].astype(np.float32)
    return {
        "ids": ids,
        "pids": pids,
        "valid": mask.astype(bool),
        "targets": targets,
        "loss_masks": loss_masks,
        "loss_scales": loss_scales,
    }


def batch_to(batch: dict, device) -> dict:
    """A :func:`_prepare_batch` dict as tensors on ``device``."""
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def make_loss_fn(cfg, lora_dropout: float = 0.0):
    """``loss_fn(trainable, frozen, batch)``: the scaled sum of each row's
    mean cross-entropy over its loss mask (``batch`` as :func:`batch_to`
    gives it, or with ``rope``, the (cos, sin) tables, in place of ``pids``;
    plus ``dropout_rng``, the step key, for LoRA dropout)."""

    def loss_fn(trainable, frozen, batch):
        params = merge_lora(frozen, trainable)
        logits = phi3.forward_nocache(
            params,
            cfg,
            batch["ids"],
            pids=batch.get("pids"),
            prompt_valid=batch["valid"],
            dropout_rng=batch.get("dropout_rng"),
            lora_dropout=lora_dropout,
            allow_flash=False,  # K2 is forward-only
            rope=batch.get("rope"),
        )
        logits = logits[:, :-1].float()
        ce = -torch.log_softmax(logits, dim=-1).gather(-1, batch["targets"].long()[..., None])[..., 0]
        masks = batch["loss_masks"]
        ce = (ce * masks).sum(dim=1) / masks.sum(dim=1).clamp(min=1.0)
        return (ce * batch["loss_scales"]).sum()

    return loss_fn


def step_inputs(cfg, batch: dict) -> tuple:
    """A training batch (:func:`batch_to`'s dict plus ``rate`` (1,) f32 and
    ``key`` (2,) int64) as the static step's inputs, in :func:`lora_step`'s
    order; the RoPE tables are made here from the pids (``su_rope_tables``
    copies host values to the device, which a capture refuses)."""
    cos, sin = su_rope_tables(cfg, batch["ids"].shape[1], batch["pids"], device=batch["ids"].device)
    return (batch["ids"], cos, sin, batch["valid"], batch["targets"], batch["loss_masks"], batch["loss_scales"],
            batch["rate"], batch["key"])


def lora_step(loss_fn, trainable: dict, frozen: dict, layer_mask, optimizer: AdamW, dropout: bool):
    """The LoRA training step on device tensors (the JAX trainer's jitted
    ``train_step``): ``step(ids, cos, sin, valid, targets, loss_masks,
    loss_scales, rate, key)`` computes the loss, its gradients with respect
    to the optimizer's params (``trainable``'s leaves), masks the inactive
    layers' and takes one AdamW step at ``rate``, in place; it returns the
    loss.  No host value is read, so the step can be captured.  ``key`` is
    the dropout's step key (used with ``dropout``)."""
    active = torch.as_tensor(layer_mask).tolist()
    mask = torch.as_tensor(layer_mask).to(optimizer.params[0].device)

    def step(ids, cos, sin, valid, targets, loss_masks, loss_scales, rate, key):
        batch = dict(ids=ids, rope=(cos, sin), valid=valid, targets=targets, loss_masks=loss_masks,
                     loss_scales=loss_scales, dropout_rng=key if dropout else None)
        loss = loss_fn(active_layers(trainable, active), frozen, batch)
        grads = torch.autograd.grad(loss, optimizer.params)
        optimizer.step([mask_lora_grads(g, mask) for g in grads], lr=rate)
        return loss.detach()

    return step


def train_lora(
    model_path: str = None,
    adapter_path: Optional[str] = None,
    lora_targets: List[str] = ["self_attn.qkv_proj"],
    lora_layers=1,
    lora_rank: int = 1,
    epochs: int = 1,
    batch_size: int = 1,
    take: int = 10,
    lr: float = 1e-4,
    warmup: float = 0.5,
    mask_ratios=None,
    dataset_path: str = "JosefAlbers/akemiH_MedQA_Reason",
    seed: int = 0,
    lora_dropout: float = 0.0,
    resume: bool = False,
    checkpoint_every: int = 0,
    device="cuda",
):
    """Fine-tune a LoRA adapter (reference ``train_lora``, :898-1046) on
    ``device``; the adapter goes to ``adapter_path`` (default
    ``adapters/<model name>``).

    Beyond the reference, as in the JAX package: ``lora_dropout`` (the
    reference LoRALinear knob), and exact mid-run resume:
    ``checkpoint_every=N`` saves (trainable, optimizer state, next step)
    under ``<adapter_path>/train_state`` every N steps, and ``resume=True``
    restores the latest and continues from the next batch.
    """
    from ..api import PATH_QUANTIZED_PHI3_BLIND, _get_adapter_path, _load

    model_path = model_path or PATH_QUANTIZED_PHI3_BLIND
    if adapter_path is None:
        adapter_path = _get_adapter_path(model_path)
    lm, processor = _load(model_path, device=device)
    cfg = lm.cfg
    rows = load_qa_dataset(dataset_path, take)
    list_prompts = _prompt_rows(rows)

    rng = random.Random(seed)
    batch_idx = []
    for _ in range(epochs):
        order = rng.sample(range(len(rows)), len(rows))
        batch_idx += [
            order[i : i + batch_size]
            for i in range(0, len(order) - batch_size + 1, batch_size)
        ]

    lora_cfg = {
        "model_path": str(model_path),
        "adapter_path": str(adapter_path),
        "lora_layers": lora_layers,
        "lora_targets": lora_targets,
        "lora_parameters": {
            "rank": lora_rank, "alpha": lora_rank, "dropout": lora_dropout,
            "scale": 1.0,
        },
    }
    params, layer_mask = inject_lora(
        lm.params, cfg, lora_targets, lora_layers, lora_rank,
        torch.Generator().manual_seed(seed), alpha=lora_rank, scale=1.0,
    )
    trainable, frozen = partition_lora(params)
    leaves = [t.requires_grad_() for t in lora_leaves(trainable)]

    lr_schedule = _get_lr_schedule(lr, len(batch_idx), warmup)
    optimizer = AdamW(leaves, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01)
    step_fn = lora_step(make_loss_fn(cfg, lora_dropout), trainable, frozen, layer_mask, optimizer,
                        lora_dropout > 0.0)

    callback = TrainingCallback(lora_cfg, lr_schedule, batch_idx)

    def save_adapter():
        flat = adapter_flat_dict(merge_lora(frozen, trainable), layer_mask, lora_targets)
        W.save_safetensors(f"{adapter_path}/adapters.safetensors", flat)

    callback._save_adapter = save_adapter

    state_dir = f"{adapter_path}/train_state"
    start_step = 0
    if resume:
        from .checkpoint import restore_train_state

        restored = restore_train_state(state_dir)
        if restored is not None:
            state, _ = restored
            with torch.no_grad():
                for t, saved in zip(leaves, lora_leaves(state["trainable"])):
                    t.copy_(saved)
            optimizer.load_state_dict(state["optimizer"])
            start_step = int(state["next_step"])
            callback.current_step = start_step
            print(f"Resumed training from step {start_step}")

    # One static step a (rows, bucketed length); with graphs, one memory pool.
    steps = callback.steps
    pool = torch.cuda.graph_pool_handle() if lm.graphs else None
    # Per-batch RNGs drawn up front so a resumed run augments identically to
    # an uninterrupted one (skipped batches must not shift the stream).
    batch_rngs = [random.Random(rng.random()) for _ in batch_idx]
    for i, idx in enumerate(batch_idx):
        if i < start_step:
            continue
        batch = _prepare_batch(processor, [list_prompts[j] for j in idx], mask_ratios, batch_rngs[i])
        batch["rate"] = np.asarray([lr_schedule[i]], np.float32)
        batch["key"] = np.asarray([seed + 1, i], np.int64)  # the dropout's step key
        args = step_inputs(cfg, batch_to(batch, lm.device))
        shape = tuple(args[0].shape)
        if shape not in steps:
            steps[shape] = StaticStep(step_fn, [torch.empty_like(a) for a in args],
                                      torch.zeros((), dtype=torch.float32, device=lm.device), lm.device,
                                      lm.graphs, save=leaves + optimizer.state_tensors(), pool=pool)
        lvalue = steps[shape](*args)
        callback(float(lvalue))
        if checkpoint_every and (i + 1) % checkpoint_every == 0:
            from .checkpoint import save_train_state

            save_train_state(state_dir, i + 1, trainable, optimizer, next_step=i + 1)
    callback.end_log()
    del lm


def test_lora(
    model_path: str = None,
    adapter_path=True,
    dataset_path: str = "JosefAlbers/akemiH_MedQA_Reason",
    take=(0, 10),
    batch_size: int = 1,
    test_result_path: str = "test_result.csv",
    device="cuda",
):
    """Evaluate recall and three answering methods (reference ``test_lora``,
    :1048-1176) on ``device``: 30-token recall generation, ``choose`` over
    A-E, greedy ``constrain`` and beam ``constrain``; prints the scores,
    writes a CSV and returns the three scores."""
    from ..api import PATH_QUANTIZED_PHI3_BLIND, _get_adapter_path, _load
    from ..engine.constrain import choose_from, constrain_decode
    from ..engine.engine import generate_text

    model_path = model_path or PATH_QUANTIZED_PHI3_BLIND
    if adapter_path is True:
        adapter_path = _get_adapter_path(model_path)
    lm, processor = _load(model_path=model_path, adapter_path=adapter_path, device=device)
    take = (0, take) if isinstance(take, int) else take
    rows = load_qa_dataset(dataset_path, take)

    def batched(items):
        for i in range(0, len(items), batch_size):
            yield i, items[i : i + batch_size]

    results = {r_i: dict(row) for r_i, row in enumerate(rows)}
    specs = [
        dict(
            a_col="summary_attempt", c_col="summary", q_until=" A: ", q_format="",
            fxn=lambda prompts: generate_text(
                lm, processor, prompts if len(prompts) > 1 else prompts[0],
                max_tokens=30, verbose=False, stream=False, mute=True,
            ),
            a_format=None,
        ),
        dict(
            a_col="choice_attempt", c_col="output", q_until=None,
            q_format="\nThe correct answer is",
            fxn=lambda prompts: choose_from(lm, processor, prompts, "ABCDE", mute=True),
            a_format=None,
        ),
        dict(
            a_col="constrained_attempt", c_col="output", q_until=None, q_format="",
            fxn=lambda prompts: constrain_decode(
                lm, processor, prompts,
                constraints=[(0, "\nThe"), (100, " The correct answer is"), "ABCDE"],
                verbose=False, mute=True, use_beam=False,
            ),
            a_format="The correct answer is ",
        ),
        dict(
            a_col="beamed_attempt", c_col="output", q_until=None, q_format="",
            fxn=lambda prompts: constrain_decode(
                lm, processor, prompts,
                constraints=[(0, "\nThe"), (100, " The correct answer is"), "ABCDE"],
                verbose=False, mute=True, use_beam=True,
            ),
            a_format="The correct answer is ",
        ),
    ]
    for spec in specs:
        for start, chunk in batched(rows):
            questions = [r["input"] for r in chunk]
            if spec["q_until"]:
                questions = [q.rsplit(spec["q_until"], 1)[0].strip() for q in questions]
            prompts = [
                f"<|user|>\n{q}<|end|>\n<|assistant|>{spec['q_format']}"
                for q in questions
            ]
            attempts = spec["fxn"](prompts)
            if isinstance(attempts, str):
                attempts = [attempts]
            for j, att in enumerate(attempts):
                ans = att
                if spec["a_format"]:
                    pos = att.find(spec["a_format"])
                    ans = (
                        att[pos + len(spec["a_format"])].strip()
                        if pos >= 0 and pos + len(spec["a_format"]) < len(att)
                        else ""
                    )
                results[start + j][spec["a_col"]] = ans

    n = len(rows)
    num_chosen = sum(
        1 for r in results.values() if r.get("output") == r.get("choice_attempt")
    )
    print(f"Score w/ _choose_from(): {num_chosen/n}({num_chosen}/{n})")
    num_constr = sum(
        1 for r in results.values() if r.get("output") == r.get("constrained_attempt")
    )
    print(f"Score w/ _constrain():   {num_constr/n}({num_constr}/{n})")
    num_beamed = sum(
        1 for r in results.values() if r.get("output") == r.get("beamed_attempt")
    )
    print(f"Score w/ _beam():        {num_beamed/n}({num_beamed}/{n})")
    import csv

    cols = sorted({k for r in results.values() for k in r})
    with open(test_result_path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=cols)
        w.writeheader()
        for i in range(n):
            w.writerow({k: results[i].get(k, "") for k in cols})
    del lm
    return {
        "choose": num_chosen / n,
        "constrain": num_constr / n,
        "beam": num_beamed / n,
    }
