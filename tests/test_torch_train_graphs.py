"""The port's capturable training steps on the CPU (``train/adamw.py``,
``train/trainer.py:lora_step``, ``train/pretrain.py``'s chunks through
``engine/graphs.py:StaticStep``), the induction helpers, the registry and
the small functions ported with them, against the JAX package.

On the card a training step is one CUDA graph replay; here the same step
runs eagerly on its static tensors, which is what the card captures.  The
tests hold the AdamW update to ``torch.optim.AdamW`` and optax, show that
no step dispatches a host sync (``tests/test_torch_graphs.py:SYNCS``), run
``train_lora`` and ``pretrain`` with every step a stub capture (the capture
runs nothing, as the card's does) bit for bit against the eager run, pin
the device-keyed dropout mask, and hold ``pretrain(scan_steps=)``,
``train_induction_lm``, ``measure_tokens_per_pass``, ``register`` and
``lookup`` to the JAX package.
"""

import json
import os
import random
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

torch = pytest.importorskip("torch")

from test_torch_graphs import SYNCS, StubStepGraph, _recorded  # noqa: E402
from test_torch_lora import _short_rows, port_cfg  # noqa: E402
from test_torch_model import make_checkpoint  # noqa: E402
from test_torch_model import one_thread  # noqa: E402,F401  (autouse: one torch thread)

from phi_3_vision_mlx_tpu import api as JAPI  # noqa: E402
from phi_3_vision_mlx_tpu.core import config as JC  # noqa: E402
from phi_3_vision_mlx_tpu.core import registry as JR  # noqa: E402
from phi_3_vision_mlx_tpu.models import phi3 as JM  # noqa: E402
from phi_3_vision_mlx_tpu.ops import attention as JA  # noqa: E402
from phi_3_vision_mlx_tpu.ops import linear as JL  # noqa: E402
from phi_3_vision_mlx_tpu.ops import quant as JQ  # noqa: E402
from phi_3_vision_mlx_tpu.ops import rope as JROPE  # noqa: E402
from phi_3_vision_mlx_tpu.train import pretrain as JP  # noqa: E402
from phi_3_vision_mlx_tpu_torch import api as TAPI  # noqa: E402
from phi_3_vision_mlx_tpu_torch.core import config as TC  # noqa: E402
from phi_3_vision_mlx_tpu_torch.core import registry as TR  # noqa: E402
from phi_3_vision_mlx_tpu_torch.core import weights as TW  # noqa: E402
from phi_3_vision_mlx_tpu_torch.core.convert import from_numpy_params  # noqa: E402
from phi_3_vision_mlx_tpu_torch.engine import graphs as TG  # noqa: E402
from phi_3_vision_mlx_tpu_torch.models import phi3 as TM  # noqa: E402
from phi_3_vision_mlx_tpu_torch.ops import attention as TA  # noqa: E402
from phi_3_vision_mlx_tpu_torch.ops import linear as TL  # noqa: E402
from phi_3_vision_mlx_tpu_torch.ops import quant as TQ  # noqa: E402
from phi_3_vision_mlx_tpu_torch.ops import rope as TROPE  # noqa: E402
from phi_3_vision_mlx_tpu_torch.ops.kernels import flash_attention as K2  # noqa: E402
from phi_3_vision_mlx_tpu_torch.train import lora as TLORA  # noqa: E402
from phi_3_vision_mlx_tpu_torch.train import pretrain as TP  # noqa: E402
from phi_3_vision_mlx_tpu_torch.train import trainer as TT  # noqa: E402
from phi_3_vision_mlx_tpu_torch.train.adamw import AdamW  # noqa: E402

LOSS_RTOL = 1e-4  # as tests/test_torch_train.py: fp32 on both sides, sums in another order
# AdamW against torch.optim.AdamW and optax: params of O(1) after six steps
# of up to 1e-2; the three round the same update in another order, a few
# f32 ulps of 1 (measured 2.4e-7 against torch).
ADAMW_ATOL = 1e-6
RATES = (0.0, 1e-3, 5e-4, 1e-2, 1e-6, 3e-3)  # a warmup's first rate is 0
TARGETS = ["self_attn.qkv_proj", "mlp.down_proj"]
# A narrow induction model: the tiny preset at hidden 64 over 2 heads of 32.
NARROW = dict(hidden_size=64, intermediate_size=128, num_attention_heads=2, num_key_value_heads=2)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return make_checkpoint(tmp_path_factory.mktemp("ckpt"), "tiny")


# -- AdamW ----------------------------------------------------------------------------


def test_adamw_matches_torch_and_optax():
    """Six steps at RATES (0 first) on the same gradients: the params within
    ADAMW_ATOL of ``torch.optim.AdamW`` and of ``optax.adamw`` under
    ``inject_hyperparams``; the state dict restores a run that then goes on
    bit for bit."""
    rng = np.random.default_rng(0)
    shapes = [(5, 7), (3, 4, 2), (9,)]
    init = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in shapes] for _ in RATES]
    mine = [torch.from_numpy(a.copy()) for a in init]
    opt = AdamW(mine)
    ref = [torch.from_numpy(a.copy()).requires_grad_() for a in init]
    ref_opt = torch.optim.AdamW(ref, lr=RATES[0], betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01)
    tx = optax.inject_hyperparams(optax.adamw)(learning_rate=RATES[0], weight_decay=0.01)
    jparams = [jnp.asarray(a) for a in init]
    jstate = tx.init(jparams)
    saved = None
    for i, (rate, g) in enumerate(zip(RATES, grads)):
        opt.step([torch.from_numpy(x) for x in g], lr=torch.tensor([rate]))
        for t, x in zip(ref, g):
            t.grad = torch.from_numpy(x)
        for group in ref_opt.param_groups:
            group["lr"] = rate
        ref_opt.step()
        jstate.hyperparams["learning_rate"] = jnp.float32(rate)
        updates, jstate = tx.update([jnp.asarray(x) for x in g], jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        if i == 2:
            saved = ([t.clone() for t in mine], opt.state_dict())
    assert float(opt.count) == len(RATES)
    for t, r, j in zip(mine, ref, jparams):
        np.testing.assert_allclose(t.numpy(), r.detach().numpy(), rtol=0, atol=ADAMW_ATOL)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=ADAMW_ATOL)
    again = [t.clone() for t in saved[0]]
    resumed = AdamW(again)
    resumed.load_state_dict(saved[1])
    for rate, g in zip(RATES[3:], grads[3:]):
        resumed.step([torch.from_numpy(x) for x in g], lr=torch.tensor([rate]))
    assert all(torch.equal(a, b) for a, b in zip(again, mine))


# -- no host sync in a step -----------------------------------------------------------


def _lora_step(ckpt, n_prompts, mask_ratios, lora_dropout):
    """(step, its inputs, the trainable leaves) of ``train_lora``'s step on
    the 4-bit tiny checkpoint (LoRA on TARGETS of both layers, B random so
    that A takes gradients)."""
    lm, proc = TAPI._load(ckpt, device="cpu")
    params, mask = TLORA.inject_lora(lm.params, lm.cfg, TARGETS, 2, 2, torch.Generator().manual_seed(0))
    trainable, frozen = TLORA.partition_lora(params)
    g = torch.Generator().manual_seed(1)
    for t in TARGETS:
        node = TLORA._target(trainable["model"]["layers"], t)
        node["lora_b"].copy_(0.05 * torch.randn(node["lora_b"].shape, generator=g))
    leaves = [t.requires_grad_() for t in TLORA.lora_leaves(trainable)]
    opt = AdamW(leaves)
    step = TT.lora_step(TT.make_loss_fn(lm.cfg, lora_dropout), trainable, frozen, mask, opt, lora_dropout > 0)
    batch = TT._prepare_batch(proc, TT._prompt_rows(_short_rows(n_prompts)), mask_ratios, random.Random(0))
    batch["rate"] = np.asarray([1e-3], np.float32)
    batch["key"] = np.asarray([1, 0], np.int64)
    return step, TT.step_inputs(lm.cfg, TT.batch_to(batch, "cpu")), leaves


@pytest.mark.parametrize("n_prompts, mask_ratios, dropout", [(1, None, 0.1), (1, [0.0, 0.1, 0.2, 0.3], 0.0)],
                         ids=["64-rows-dropout", "320-rows-mask_ratios"])
def test_lora_step_has_no_host_sync(ckpt, n_prompts, mask_ratios, dropout):
    """One LoRA step at 64 rows (the K1 seam; with dropout) and at 320 (the
    dequantize route; ``mask_ratios`` makes 5 rows of 64): the forward, the
    gradients and the update dispatch no op in SYNCS, and the step moves
    every trainable leaf."""
    step, args, leaves = _lora_step(ckpt, n_prompts, mask_ratios, dropout)
    assert args[0].numel() == (64 if n_prompts * (1 + len(mask_ratios or ())) == 1 else 320)
    before = [t.detach().clone() for t in leaves]
    ops = _recorded(lambda: step(*args))
    assert ops and not SYNCS & set(ops), sorted(SYNCS & set(ops))
    assert {"lerp_", "addcmul_"} <= set(ops)
    assert all(not torch.equal(a, b) for a, b in zip(before, leaves))


def _narrow_pretrain_setup():
    """A 1-layer narrow induction config in both packages, JAX's initial
    weights as numpy, and three (2, 64) batches."""
    jcfg = JC.preset("tiny", vocab_size=TP.INDUCTION_VOCAB, num_hidden_layers=1, **NARROW)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, jparams, jax.tree_util.tree_map(np.asarray, jparams), TP.induction_batches(1, 3, 2, 64)


def test_pretrain_chunk_has_no_host_sync():
    """A ``pretrain`` chunk of two steps (``chunk_step``): no op in SYNCS,
    one loss a step, every parameter moved."""
    jcfg, _, np_params, batches = _narrow_pretrain_setup()
    tcfg = port_cfg(jcfg)
    params = from_numpy_params(np_params, tcfg)
    leaves = [t.requires_grad_() for t in jax.tree_util.tree_leaves(params)]
    opt = AdamW(leaves)
    rope = TROPE.su_rope_tables(tcfg, 64, None, device="cpu")
    chunk = TP.chunk_step(TP.make_clm_loss(tcfg), params, leaves, opt, rope)
    ids = torch.from_numpy(np.stack([b[0] for b in batches[:2]]))
    valid = torch.from_numpy(np.stack([b[1] for b in batches[:2]]))
    rates = torch.tensor([1e-3, 2e-3])
    before = [t.detach().clone() for t in leaves]
    out = {}
    ops = _recorded(lambda: out.setdefault("losses", chunk(ids, valid, rates)))
    assert ops and not SYNCS & set(ops), sorted(SYNCS & set(ops))
    assert out["losses"].shape == (2,) and float(opt.count) == 2
    assert all(not torch.equal(a, b) for a, b in zip(before, leaves))


# -- stub captures against the eager run ----------------------------------------------


def stub_graphs(monkeypatch):
    """Every ``StepGraph`` a stub whose capture runs nothing (its ``touched``
    are the step's ``save``: the trainable tensors and the optimizer
    state); the made graphs are listed."""
    made = []

    def make(step, device, graphs, save=(), pool=None):
        g = StubStepGraph(step, device, graphs, save=save, touched=save)
        made.append(g)
        return g

    monkeypatch.setattr(TG, "StepGraph", make)
    return made


def _graphs_on(monkeypatch):
    """``train_lora``'s model with ``graphs`` on (stub captures on the CPU)."""
    real = TAPI._load

    def load(*a, **k):
        lm, proc = real(*a, **k)
        lm.graphs = True
        return lm, proc

    monkeypatch.setattr(TAPI, "_load", load)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)


def _adapters(path):
    return TW.load_safetensors(f"{path}/adapters.safetensors")


def _losses(path):
    with open(f"{path}/adapter_train_log.json") as f:
        return json.load(f)["step_loss"]


def test_train_lora_stub_graphs_match_eager(ckpt, tmp_path, monkeypatch):
    """``train_lora`` (``mask_ratios``, LoRA dropout, 4 steps) with every
    step a stub capture at its shape's first batch, then replays: the
    losses and the adapter equal the eager run's bit for bit; so does a run
    resumed from step 2 with graphs against the uninterrupted eager one."""
    monkeypatch.chdir(tmp_path)
    kw = dict(model_path=ckpt, lora_targets=TARGETS, lora_layers=1, lora_rank=2, take=4, dataset_path="synthetic",
              mask_ratios=[0.2], lora_dropout=0.1, seed=3, device="cpu")
    TT.train_lora(adapter_path=str(tmp_path / "eager"), **kw)
    with monkeypatch.context() as mp:
        made = stub_graphs(mp)
        _graphs_on(mp)
        TT.train_lora(adapter_path=str(tmp_path / "graph"), **kw)
        assert made and all(g.graphs and g.graph is not None for g in made)
        resumed = str(tmp_path / "resumed")
        TT.train_lora(adapter_path=resumed, checkpoint_every=1, **kw)
        for step in ("3", "4"):
            shutil.rmtree(f"{resumed}/train_state/{step}")
        os.remove(f"{resumed}/adapters.safetensors")
        TT.train_lora(adapter_path=resumed, resume=True, **kw)
    eager, graph = _losses(tmp_path / "eager"), _losses(tmp_path / "graph")
    assert len(eager) == 4 and graph == eager
    assert _losses(resumed) == eager[2:]
    want = _adapters(tmp_path / "eager")
    for path in (tmp_path / "graph", resumed):
        got = _adapters(path)
        assert sorted(got) == sorted(want) and all(torch.equal(got[k], want[k]) for k in want)


# -- the device-keyed dropout ---------------------------------------------------------


def test_lora_dropout_mask_is_keyed_on_the_device_key():
    """The mask is a function of (seed, step, layer, linear) only: the same
    key gives the same mask whatever the global RNG, as a tuple or a device
    tensor; another step, seed, layer or linear gives another; the keep
    share lies within 5 binomial sigmas of ``keep``."""
    shape, keep = (2, 64, 96), 0.9
    key = torch.tensor([4, 7])
    torch.manual_seed(0)
    a = TM.lora_dropout_mask(key, 1, 0, shape, keep, "cpu")
    torch.manual_seed(1)
    assert torch.equal(a, TM.lora_dropout_mask((4, 7), 1, 0, shape, keep, "cpu"))
    for other in (((4, 8), 1, 0), ((5, 7), 1, 0), ((4, 7), 0, 0), ((4, 7), 1, 3)):
        assert not torch.equal(a, TM.lora_dropout_mask(other[0], other[1], other[2], shape, keep, "cpu"))
    n = a.numel()
    for m in (a, TM.lora_dropout_mask((4, 8), 1, 0, shape, keep, "cpu")):
        assert m.dtype == torch.bool and m.shape == shape
        assert abs(float(m.float().mean()) - keep) <= 5 * (keep * (1 - keep) / n) ** 0.5


# -- pretrain(scan_steps=) ----------------------------------------------------------------


def test_pretrain_scan_steps_match_one_step_and_jax(monkeypatch):
    """``pretrain(scan_steps=4)`` over 6 steps (a chunk of 4, a tail of 2)
    equals ``scan_steps=1`` bit for bit, and so does the same run with
    every chunk a stub capture; its losses lie within LOSS_RTOL of the JAX
    ``pretrain(scan_steps=4)``."""
    jcfg, jparams, np_params, batches = _narrow_pretrain_setup()
    tcfg = port_cfg(jcfg)
    kw = dict(lr=1e-3, warmup=2, steps=6)

    def run(**more):
        params, losses = TP.pretrain(tcfg, from_numpy_params(np_params, tcfg), batches, **kw, **more)
        return jax.tree_util.tree_leaves(params), losses

    p4, l4 = run(scan_steps=4)
    p1, l1 = run(scan_steps=1)
    with monkeypatch.context() as mp:
        made = stub_graphs(mp)
        mp.setattr(TP, "StaticStep", lambda fn, inputs, out, device, graphs, save=(), pool=None: TG.StaticStep(
            fn, inputs, out, device, True, save=save))
        ps, ls = run(scan_steps=4)
        assert [g.graph is not None for g in made] == [True, True]  # the chunk of 4, the tail of 2
    assert len(l4) == 6 and l4 == l1 == ls
    assert all(torch.equal(a, b) and torch.equal(a, c) for a, b, c in zip(p4, p1, ps))
    _, jl = JP.pretrain(jcfg, jparams, batches, scan_steps=4, **kw)
    np.testing.assert_allclose(l4, jl, rtol=LOSS_RTOL, atol=0)


# -- train_induction_lm and measure_tokens_per_pass -------------------------------------


def test_train_induction_lm_and_tokens_a_pass_match_jax(tmp_path, monkeypatch):
    """``train_induction_lm`` (4 steps of 2 x 64, ``scan_steps=2``, the
    narrow config) from JAX's initial weights: the losses within LOSS_RTOL
    of JAX's; each package's ``_load`` reads the other's checkpoint (the
    same config and weights); ``measure_tokens_per_pass`` on JAX's fp32
    checkpoint gives JAX's tokens a pass and text."""
    kw = dict(steps=4, bs=2, seq_len=64, n_batches=3, scan_steps=2, **NARROW)
    jcfg, jlosses = JP.train_induction_lm(str(tmp_path / "jax"), **kw)
    jinit = jax.tree_util.tree_map(np.asarray, JM.init_params(jcfg, jax.random.PRNGKey(0)))
    monkeypatch.setattr(TM, "init_params", lambda cfg, generator, dtype=None: from_numpy_params(jinit, cfg))
    tcfg, tlosses = TP.train_induction_lm(str(tmp_path / "torch"), device="cpu", **kw)
    assert tcfg.head_dim == 32 and TC.config_to_dict(tcfg) == JC.config_to_dict(jcfg)
    np.testing.assert_allclose(tlosses, jlosses, rtol=LOSS_RTOL, atol=0)
    for writer in ("jax", "torch"):
        jlm, _ = JAPI._load(str(tmp_path / writer))
        tlm, _ = TAPI._load(str(tmp_path / writer), device="cpu")
        for j, t in zip(jax.tree_util.tree_leaves(jlm.params), jax.tree_util.tree_leaves(tlm.params)):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    monkeypatch.setenv("PHI3V_TPU_SPEC_K", "7")
    doc = TP.induction_docs(np.random.default_rng(99), 1, n_phrases=4, phrase_len=8, phrases_per_doc=6)[0]
    want = JP.measure_tokens_per_pass(JAPI._load(str(tmp_path / "jax")), doc, max_tokens=24)
    got = TP.measure_tokens_per_pass(TAPI._load(str(tmp_path / "jax"), device="cpu"), doc, max_tokens=24)
    assert got == want and got[0] >= 1.0


# -- the registry and the small ports -------------------------------------------------------


def test_registry_register_and_lookup_match_jax(monkeypatch):
    """Exact names, a prefix match, an unknown name (``KeyError``) and a
    newly registered architecture behave as in the JAX package."""
    monkeypatch.setattr(TR, "_REGISTRY", dict(TR._REGISTRY))
    monkeypatch.setattr(JR, "_REGISTRY", dict(JR._REGISTRY))
    for name in ("Phi3ForCausalLM", "Phi3VForCausalLM", "Phi3ForTokenClassification", "Phi3Vision"):
        t, j = TR.lookup(name), JR.lookup(name)
        assert t["has_vision"] == j["has_vision"]
        assert TR.processor_for(name).__name__ == JR.processor_for(name).__name__
    for reg in (TR, JR):
        with pytest.raises(KeyError, match="unknown architecture"):
            reg.lookup("LlamaForCausalLM")
        reg.register("LlamaForCausalLM", has_vision=True, processor_factory=lambda: dict)
        assert reg.lookup("LlamaForCausalLM")["has_vision"] is True
        assert reg.processor_for("LlamaForCausalLM") is dict
        assert reg.lookup("LlamaMoeForCausalLM")["has_vision"] is True  # its prefix "Llama"
    assert TR.ArchEntry._fields == JR.ArchEntry._fields


def _small_port(name, tmp_path):
    """(port value, JAX value) of one small ported function: arrays for the
    float results, else values to compare exactly."""
    rng = np.random.default_rng(4)
    if name == "load_config":
        path = tmp_path / "config.json"
        path.write_text(json.dumps(JC.config_to_dict(JC.preset("tiny"))))
        return (TC.config_to_dict(TC.load_config(str(path), vocab_size=1280)),
                JC.config_to_dict(JC.load_config(str(path), vocab_size=1280)))
    if name == "quantize_for_saving":
        w = (0.05 * rng.standard_normal((96, 128))).astype(np.float32)
        out = {}
        for mode in ("affine", "symmetric"):
            q = TC.QuantConfig(group_size=64, bits=4, mode=mode)
            got = TQ.quantize_for_saving(torch.from_numpy(w), q)
            want = JQ.quantize_for_saving(jnp.asarray(w), JC.QuantConfig(group_size=64, bits=4, mode=mode))
            out[mode] = ({k: v.numpy().tolist() for k, v in got.items()},
                         {k: np.asarray(v).tolist() for k, v in want.items()})
        return {m: v[0] for m, v in out.items()}, {m: v[1] for m, v in out.items()}
    if name == "prefill_attention":
        q = rng.standard_normal((2, 4, 12, 32)).astype(np.float32)
        k, v = (rng.standard_normal((2, 2, 12, 32)).astype(np.float32) for _ in range(2))
        valid = np.ones((2, 12), bool)
        valid[1, :3] = False
        got = TA.prefill_attention(*map(torch.from_numpy, (q, k, v, valid)), 32**-0.5).numpy()
        want = np.asarray(JA.prefill_attention(*map(jnp.asarray, (q, k, v, valid)), 32**-0.5))
        return got.transpose(0, 2, 1, 3)[valid], want.transpose(0, 2, 1, 3)[valid]  # a pad query's row differs
    if name == "su_rope_tables_np":
        pids = np.arange(10)[None].repeat(2, 0) + np.array([[0], [3]])
        got = TROPE.su_rope_tables_np(port_cfg(JC.preset("tiny")), 300, pids)
        want = JROPE.su_rope_tables_np(JC.preset("tiny"), 300, pids)
        return np.stack(got), np.stack([np.asarray(a) for a in want])
    if name == "is_quantized":
        leaves = ({"weight": 0}, {"weight": 0, "scales": 0, "biases": 0})
        return [TL.is_quantized(p) for p in leaves], [JL.is_quantized(p) for p in leaves]
    if name == "hub_ids":
        return (TAPI.HUB_VISION, TAPI.HUB_BLIND), (JAPI.HUB_VISION, JAPI.HUB_BLIND)
    raise KeyError(name)


@pytest.mark.parametrize("name", ["load_config", "quantize_for_saving", "prefill_attention", "su_rope_tables_np",
                                  "is_quantized", "hub_ids"])
def test_small_port_matches_jax(name, tmp_path):
    """Each function ported for the name-level counterpart check against
    its JAX twin: config fields, quantized levels, scales and biases,
    attention outputs and RoPE tables to 1e-5, the flags and the hub ids."""
    got, want = _small_port(name, tmp_path)
    if isinstance(want, np.ndarray):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    else:
        assert got == want


def test_k2_k3_take_head_dim_32():
    """K2's and K3's input checks take the induction model's head dim of 32
    (bf16 and fp32), beside 96; the int4-cache and paged kernels (K4-K7)
    keep 96 only."""
    for d in (32, 96):
        for dtype in (torch.bfloat16, torch.float32):
            q = torch.empty((1, 4, 8, d), dtype=dtype, device="meta")
            k = torch.empty((1, 2, 64, d), dtype=dtype, device="meta")
            K2.check_attention_inputs(q, k, k, torch.empty((1, 64), dtype=torch.bool, device="meta"), "flash_attention")
    assert K2.HEAD_DIMS == (32, 96) and K2.CACHE_HEAD_DIMS == (96,)
    with pytest.raises(ValueError, match="head dim 64"):
        q = torch.empty((1, 4, 8, 64), dtype=torch.bfloat16, device="meta")
        K2.check_attention_inputs(q, q, q, torch.empty((1, 8), dtype=torch.bool, device="meta"), "flash_attention")
