"""The port's LoRA math against the JAX package on the CPU in fp32:
``ops/linear.py:dense`` with LoRA leaves over every base layout, the
autograd seam (``ops/kernels/quant_matmul.py``: K1/K8/K9 and the dequantize
route under a gradient), the LoRA-branch dropout with JAX's masks handed
over, ``ops/attention.py:blockwise_attention`` and its gradient,
``train/lora.py``'s tree surgery, adapter files both ways, the float32
LoRA leaves through conversion and ``prepare_params``, a captured decode
step over LoRA leaves, and the package's export table.

On the CPU every seam's forward is its wrapper's plain version; the tests
walk the ``grad_fn`` chain to show the gradient goes through the seam's
``autograd.Function`` (on the card the same Function wraps the kernel).
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_graphs import SYNCS, _recorded  # noqa: E402
from test_torch_model import PROMPT, make_checkpoint  # noqa: E402
from test_torch_speculative import one_thread  # noqa: E402,F401  (autouse: one torch thread)

import phi_3_vision_mlx_tpu as JPKG  # noqa: E402
import phi_3_vision_mlx_tpu_torch as TPKG  # noqa: E402
from phi_3_vision_mlx_tpu.api import _load as jax_load  # noqa: E402
from phi_3_vision_mlx_tpu.core import weights as JW  # noqa: E402
from phi_3_vision_mlx_tpu.ops import attention as JA  # noqa: E402
from phi_3_vision_mlx_tpu.ops import linear as JL  # noqa: E402
from phi_3_vision_mlx_tpu.ops import quant as JQ  # noqa: E402
from phi_3_vision_mlx_tpu.train import lora as JLORA  # noqa: E402
from phi_3_vision_mlx_tpu.train import trainer as JT  # noqa: E402
from phi_3_vision_mlx_tpu_torch.core import weights as TW  # noqa: E402
from phi_3_vision_mlx_tpu_torch.core.config import QuantConfig, preset  # noqa: E402
from phi_3_vision_mlx_tpu_torch.core.convert import from_numpy_params  # noqa: E402
from phi_3_vision_mlx_tpu_torch.engine import engine as TE  # noqa: E402
from phi_3_vision_mlx_tpu_torch.models import phi3 as TM  # noqa: E402
from phi_3_vision_mlx_tpu_torch.ops import attention as TA  # noqa: E402
from phi_3_vision_mlx_tpu_torch.ops import linear as TL  # noqa: E402
from phi_3_vision_mlx_tpu_torch.train import lora as TLORA  # noqa: E402
from phi_3_vision_mlx_tpu_torch.train import trainer as TT  # noqa: E402

# fp32 on both sides, sums in another order: losses and gradients of O(1-10),
# outputs of O(1-20).
GRAD_RTOL = 1e-4
OUT_RTOL, OUT_ATOL = 1e-5, 2e-5
TARGETS = ["self_attn.qkv_proj", "mlp.down_proj"]


def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16).float().numpy()


def _lora(rng, k, n, r):
    return {"lora_a": (rng.standard_normal((k, r)) / np.sqrt(k)).astype(np.float32),
            "lora_b": (0.1 * rng.standard_normal((r, n))).astype(np.float32),
            "lora_scale": np.float32(0.5)}


def _leaf(kind, rng, k, n):
    """(JAX leaf, port leaf) of one base layout: full precision, 4-bit and
    8-bit affine words, and the flat packed 4-bit layout (JAX: its plain
    payload, the same function)."""
    if kind == "full":
        w = (0.05 * rng.standard_normal((k, n))).astype(np.float32)
        return {"weight": w}, {"weight": torch.from_numpy(w)}
    bits = 8 if kind == "8bit" else 4
    q = rng.integers(0, 2**bits, (k, n)).astype(np.uint8)
    s = _bf16(0.004 * (1 + 0.1 * rng.standard_normal((k // 64, n))))
    b = _bf16(-0.03 + 0.001 * rng.standard_normal((k // 64, n)))
    jleaf = {"weight": q, "scales": s, "biases": b}
    tleaf = {"weight": torch.from_numpy(q), "scales": torch.from_numpy(s), "biases": torch.from_numpy(b)}
    if kind == "packed":
        tleaf = {"weight": TW.to_packed_layout(tleaf["weight"]), "scales": tleaf["scales"].to(torch.bfloat16),
                 "biases": tleaf["biases"].to(torch.bfloat16)}
        assert TW.is_packed_leaf(tleaf)
        return jleaf, tleaf
    return jleaf, TW.prepare_linear(tleaf, bits)


def grad_fns(t) -> set:
    """Names of every node of ``t``'s autograd graph."""
    seen, names, stack = set(), set(), [t.grad_fn]
    while stack:
        f = stack.pop()
        if f is None or f in seen:
            continue
        seen.add(f)
        names.add(type(f).__name__)
        stack.extend(g for g, _ in f.next_functions)
    return names


SEAM_OF = {"full": None, "4bit": "QuantMatmulFnBackward", "8bit": "QuantMatmulW8FnBackward",
           "packed": "QuantMatmulPackedFnBackward"}


@pytest.mark.parametrize("kind", list(SEAM_OF))
def test_dense_with_lora_matches_jax(kind):
    """``dense`` with LoRA leaves (a 0-d scale, and a dropout mask) over each
    base at 8 rows (K1 / K8 / K9's plain versions) and 300 rows (the
    dequantize route) against the JAX ``dense``; the gradient to ``x``
    passes through the layout's seam."""
    rng = np.random.default_rng(3)
    k, n, r = 512, 512, 4
    jleaf, tleaf = _leaf(kind, rng, k, n)
    lo = _lora(rng, k, n, r)
    jleaf = {**jleaf, **lo}
    tleaf = {**tleaf, **{key: torch.tensor(v) for key, v in lo.items()}}
    for rows in (8, 300):
        x = rng.standard_normal((rows, k)).astype(np.float32)
        mask = (rng.random((rows, k)) < 0.7).astype(np.float32) / 0.7
        for dm in (mask, None):
            want = np.asarray(JL.dense(jleaf, jnp.asarray(x), dropout_mask=None if dm is None else jnp.asarray(dm)))
            xt = torch.from_numpy(x).requires_grad_()
            got = TL.dense(tleaf, xt, None if dm is None else torch.from_numpy(dm))
            np.testing.assert_allclose(got.detach().numpy(), want, rtol=OUT_RTOL, atol=OUT_ATOL)
        seam = SEAM_OF[kind] if rows <= TL.KERNEL_MAX_ROWS else "DequantMatmulFnBackward"
        names = grad_fns(got)
        assert kind == "full" or seam in names, names
        jx = jax.grad(lambda v: JL.dense(jleaf, v).sum())(jnp.asarray(x))
        got.sum().backward()
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jx), rtol=0, atol=1e-4)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return make_checkpoint(tmp_path_factory.mktemp("ckpt"), "tiny")


def _short_rows(n):
    return [{"input": f"Q{i}: Pick one. A: x B: y", "summary": f"It is {'xy'[i % 2]}.", "output": "AB"[i % 2]}
            for i in range(n)]


@pytest.fixture(scope="module")
def lora_pair(ckpt):
    """JAX and port params of the 4-bit tiny checkpoint with LoRA leaves on
    two targets of both layers (JAX's A, a random B so A takes gradients),
    and both processors."""
    jlm, jproc = jax_load(ckpt)
    params, mask = JLORA.inject_lora(jlm.params, jlm.cfg, TARGETS, 2, 2, jax.random.PRNGKey(5))
    rng = np.random.default_rng(6)
    for t in TARGETS:
        node = params["model"]["layers"]
        for part in t.split("."):
            node = node[part]
        node["lora_b"] = jnp.asarray(0.05 * rng.standard_normal(node["lora_b"].shape), jnp.float32)
    tree = jax.tree_util.tree_map(np.asarray, params)
    return (jlm.cfg, params, mask, jproc), (TE.LM(port_cfg(jlm.cfg), from_numpy_params(tree, port_cfg(jlm.cfg)),
                                                  device="cpu"))


def port_cfg(jcfg):
    """The port's config of a JAX config (same fields)."""
    from phi_3_vision_mlx_tpu_torch.core.config import config_from_dict
    from phi_3_vision_mlx_tpu.core.config import config_to_dict

    return config_from_dict(config_to_dict(jcfg))


def _loss_and_grads(lora_pair, batch, lora_dropout=0.0, jax_key=None):
    (jcfg, jparams, _, _), tlm = lora_pair
    jtrain, jfrozen = JLORA.partition_lora(jparams)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    if jax_key is not None:
        jbatch["dropout_rng"] = jax_key
    jloss, jgrads = jax.value_and_grad(JT.make_loss_fn(jcfg, lora_dropout))(jtrain, jfrozen, jbatch)
    ttrain, tfrozen = TLORA.partition_lora(tlm.params)
    leaves = [t.detach().clone().requires_grad_() for t in TLORA.lora_leaves(ttrain)]
    it = iter(leaves)
    ttrain = jax.tree_util.tree_map(lambda _: next(it), ttrain)
    tbatch = TT.batch_to(batch, "cpu")
    if jax_key is not None:
        tbatch["dropout_rng"] = (7, 0)
    loss = TT.make_loss_fn(tlm.cfg, lora_dropout)(ttrain, tfrozen, tbatch)
    loss.backward()
    flat = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, jgrads))
    return float(jloss), float(loss.detach()), flat, [t.grad.numpy() for t in leaves], loss


def _assert_grads(jgrads, tgrads):
    assert len(jgrads) == len(tgrads) == 2 * len(TARGETS)
    for j, t in zip(jgrads, tgrads):
        assert np.abs(j).max() > 0
        assert np.abs(t - j).max() <= GRAD_RTOL * np.abs(j).max(), (np.abs(t - j).max(), np.abs(j).max())


@pytest.mark.parametrize("n_rows", [1, 5], ids=["64", "320"])
def test_lora_gradients_match_jax(lora_pair, n_rows):
    """The trainer's loss and its gradients with respect to every LoRA
    leaf against ``jax.value_and_grad`` over the 4-bit base: one 64-token
    row (64 rows: K1 behind ``QuantMatmulFn``) and five (320 rows: the
    dequantize route behind ``DequantMatmulFn``), within GRAD_RTOL of the
    largest gradient."""
    (_, _, _, jproc), _ = lora_pair
    import random

    batch = JT._prepare_batch(jproc, TT._prompt_rows(_short_rows(n_rows)), None, random.Random(0))
    assert batch["ids"].shape == (n_rows, 64)
    jloss, tloss, jgrads, tgrads, loss = _loss_and_grads(lora_pair, batch)
    assert abs(tloss - jloss) <= GRAD_RTOL * abs(jloss)
    _assert_grads(jgrads, tgrads)
    seam = "QuantMatmulFnBackward" if n_rows * 64 <= TL.KERNEL_MAX_ROWS else "DequantMatmulFnBackward"
    assert seam in grad_fns(loss)


def test_lora_dropout_with_jax_masks_matches_jax(lora_pair, monkeypatch):
    """LoRA-branch dropout at rate 0.3: the port's mask seam
    (``phi3.lora_dropout_mask``) filled with the JAX package's masks, keyed
    per (layer, linear) as JAX folds its key; the loss and the gradients
    then equal JAX's.  The port's own masks are keyed the same way: one
    stream per (rng, layer, linear)."""
    (_, _, _, jproc), _ = lora_pair
    import random

    key = jax.random.fold_in(jax.random.PRNGKey(8), 0)
    asked = []

    def jax_mask(rng, layer, path_id, shape, keep, device):
        asked.append((layer, path_id))
        k = jax.random.fold_in(jax.random.fold_in(key, layer), path_id)
        return torch.from_numpy(np.array(jax.random.bernoulli(k, keep, tuple(shape))))

    monkeypatch.setattr(TM, "lora_dropout_mask", jax_mask)
    batch = JT._prepare_batch(jproc, TT._prompt_rows(_short_rows(2)), None, random.Random(0))
    jloss, tloss, jgrads, tgrads, _ = _loss_and_grads(lora_pair, batch, 0.3, key)
    assert sorted(set(asked)) == [(0, 0), (0, 3), (1, 0), (1, 3)]
    assert abs(tloss - jloss) <= GRAD_RTOL * abs(jloss)
    _assert_grads(jgrads, tgrads)
    monkeypatch.undo()
    m = [TM.lora_dropout_mask((7, 0), layer, pid, (2, 64, 8), 0.7, "cpu")
         for layer, pid in ((0, 0), (0, 0), (0, 3), (1, 0))]
    assert torch.equal(m[0], m[1]) and not torch.equal(m[0], m[2]) and not torch.equal(m[0], m[3])
    assert 0.6 < m[0].float().mean() < 0.8


def test_blockwise_attention_and_its_gradient_match_jax(monkeypatch):
    """``blockwise_attention`` at a small ``q_block`` (GQA, a left pad, L not
    a multiple of the blocks asked for) against JAX's, output and gradients
    of q, k, v; and ``forward_nocache`` without flash takes it from
    ``BLOCKWISE_MIN_LEN`` on, with the masked path's logits."""
    rng = np.random.default_rng(9)
    b, h, kvh, l, d = 2, 4, 2, 48, 16
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in ((b, h, l, d), (b, kvh, l, d), (b, kvh, l, d)))
    valid = np.ones((b, l), bool)
    valid[1, :5] = False
    w = rng.standard_normal((b, h, l, d)).astype(np.float32)

    def jf(q, k, v):
        return (JA.blockwise_attention(q, k, v, jnp.asarray(valid), 0.25, q_block=32, k_block=32) * w).sum()

    want = JA.blockwise_attention(*map(jnp.asarray, (q, k, v)), jnp.asarray(valid), 0.25, q_block=32, k_block=32)
    jg = jax.grad(jf, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    got = TA.blockwise_attention(tq, tk, tv, torch.from_numpy(valid), 0.25, q_block=32, k_block=32)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-5)
    (got * torch.from_numpy(w)).sum().backward()
    for t, g in zip((tq, tk, tv), jg):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=0, atol=1e-4)
    cfg = preset("tiny")
    params = TM.init_params(cfg, torch.Generator().manual_seed(0))
    ids = torch.randint(3, cfg.vocab_size, (1, 64), generator=torch.Generator().manual_seed(1))
    masked = TM.forward_nocache(params, cfg, ids, allow_flash=False)
    monkeypatch.setattr(TM, "BLOCKWISE_MIN_LEN", 64)
    called = []
    monkeypatch.setattr(TM, "blockwise_attention",
                        lambda *a: called.append(1) or TA.blockwise_attention(*a, q_block=16))
    blockwise = TM.forward_nocache(params, cfg, ids, allow_flash=False)
    assert called and torch.allclose(blockwise, masked, atol=1e-5)


def _mini_params(rng, nl=2, k=512, n=1024):
    qs = [JQ.quantize(jnp.asarray(rng.standard_normal((k, n)), jnp.float32) * 0.02, 64, 4, mode="affine")
          for _ in range(nl)]
    node = {"weight": np.stack([np.asarray(t.q) for t in qs]), "scales": np.stack([np.asarray(t.scales) for t in qs]),
            "biases": np.stack([np.asarray(t.biases) for t in qs])}
    return {"model": {"layers": {"self_attn": {"qkv_proj": node}, "mlp": {"down_proj": dict(node)}}},
            "lm_head": {"weight": np.zeros((k, 8), np.float32)}}


@pytest.mark.parametrize("layout", ["words", "packed"])
def test_lora_tree_surgery_matches_jax(layout):
    """``inject_lora`` over the K1 word layout and the flat packed layout
    reads the logical (K, N) JAX reads over its plain payload; the layer
    mask, ``partition_lora`` / ``merge_lora`` (keys and the same tensors),
    ``mask_lora_grads`` and ``adapter_flat_dict`` keys and shapes equal
    JAX's."""
    rng = np.random.default_rng(10)
    nl, k, n, r = 2, 512, 1024, 3
    jparams = _mini_params(rng, nl, k, n)
    cfg = preset("phi35_mini", num_hidden_layers=nl, quantized=QuantConfig(group_size=64, bits=4))
    tparams = TW.prepare_params(jax.tree_util.tree_map(torch.from_numpy, jparams), cfg)
    if layout == "packed":
        tparams = TW.packed_params(tparams, cfg)
        assert TW.is_packed_leaf(tparams["model"]["layers"]["self_attn"]["qkv_proj"])
    jp, jmask = JLORA.inject_lora(jax.tree_util.tree_map(jnp.asarray, jparams), cfg, TARGETS, [1], r,
                                  jax.random.PRNGKey(0))
    tp, tmask = TLORA.inject_lora(tparams, cfg, TARGETS, [1], r, torch.Generator().manual_seed(0))
    assert tp is tparams and tmask.tolist() == np.asarray(jmask).tolist() == [0.0, 1.0]
    for t in TARGETS:
        jn, tn = jp["model"]["layers"], tp["model"]["layers"]
        for part in t.split("."):
            jn, tn = jn[part], tn[part]
        for key in ("lora_a", "lora_b", "lora_scale"):
            assert tuple(tn[key].shape) == tuple(jn[key].shape) and tn[key].dtype == torch.float32
        bound = 1 / np.sqrt(k)
        assert float(tn["lora_a"][0].abs().max()) == 0 and 0 < float(tn["lora_a"][1].abs().max()) <= bound
        assert float(tn["lora_b"].abs().max()) == 0 and tn["lora_scale"].tolist() == [1.0] * nl
    jt, jf = JLORA.partition_lora(jp)
    tt, tf = TLORA.partition_lora(tp)
    keys = lambda tree: sorted(jax.tree_util.tree_flatten_with_path(tree)[0], key=str)  # noqa: E731
    assert [str(p) for p, _ in keys(tt)] == [str(p) for p, _ in keys(jt)]
    assert "lora_a" not in tf["model"]["layers"]["self_attn"]["qkv_proj"]
    merged = TLORA.merge_lora(tf, tt)
    node = merged["model"]["layers"]["self_attn"]["qkv_proj"]
    assert node["lora_a"] is tp["model"]["layers"]["self_attn"]["qkv_proj"]["lora_a"]
    grads = TLORA.mask_lora_grads({"a": torch.ones((nl, 2, 2))}, tmask)
    assert grads["a"][0].abs().max() == 0 and grads["a"][1].min() == 1
    jflat = JLORA.adapter_flat_dict(jp, jmask, TARGETS)
    tflat = TLORA.adapter_flat_dict(tp, tmask, TARGETS)
    assert sorted(tflat) == sorted(jflat) and all(tuple(tflat[k].shape) == jflat[k].shape for k in jflat)
    assert all(t.dtype == torch.float32 and t.device.type == "cpu" for t in tflat.values())


def write_adapter(path, cfg, layers, rank=2, seed=0, targets=TARGETS, model_path=""):
    """An adapter directory in the reference format, random A and B, written
    with the port's safetensors writer."""
    rng = np.random.default_rng(seed)
    flat = {}
    for t in targets:
        k = cfg.intermediate_size if t.endswith("down_proj") else cfg.hidden_size
        n = cfg.hidden_size if t.endswith(("down_proj", "o_proj")) else (
            (cfg.num_attention_heads + 2 * cfg.num_key_value_heads) * cfg.head_dim)
        for i in layers:
            a = rng.standard_normal((k, rank)) / np.sqrt(k)
            flat[f"model.layers.{i}.{t}.lora_a"] = torch.from_numpy(a.astype(np.float32))
            b = 0.2 * rng.standard_normal((rank, n))
            flat[f"model.layers.{i}.{t}.lora_b"] = torch.from_numpy(b.astype(np.float32))
    os.makedirs(path, exist_ok=True)
    TW.save_safetensors(f"{path}/adapters.safetensors", flat)
    with open(f"{path}/adapter_config.json", "w") as f:
        json.dump({"model_path": model_path, "adapter_path": path, "lora_layers": list(layers),
                   "lora_targets": list(targets),
                   "lora_parameters": {"rank": rank, "alpha": 2 * rank, "dropout": 0.0, "scale": 1.0}}, f)
    return flat


def test_load_adapter_matches_jax_and_keeps_float32(ckpt, tmp_path):
    """The port's ``load_adapter`` of an adapter directory against the JAX
    ``load_adapter`` (stacked leaves, zeros outside the adapter's layers,
    scale ``scale * alpha / rank``); the leaves stay float32 through
    ``from_numpy_params`` of a bf16 config, ``prepare_params`` and
    ``params_to``."""
    jlm, _ = jax_load(ckpt)
    write_adapter(str(tmp_path / "ad"), jlm.cfg, [1])
    jp = JW.load_adapter(jlm.params, jlm.cfg, str(tmp_path / "ad"))
    cfg, tparams = TW.load_params(ckpt)
    tp = TW.load_adapter(TW.prepare_params(tparams, cfg), cfg, str(tmp_path / "ad"))
    assert "lora_a" not in tparams["model"]["layers"]["self_attn"]["qkv_proj"]
    for t in TARGETS:
        jn, tn = jp["model"]["layers"], tp["model"]["layers"]
        for part in t.split("."):
            jn, tn = jn[part], tn[part]
        for key in ("lora_a", "lora_b", "lora_scale"):
            np.testing.assert_array_equal(tn[key].numpy(), np.asarray(jn[key]))
        assert tn["lora_scale"].tolist() == [2.0, 2.0] and float(tn["lora_b"][0].abs().max()) == 0
    bf16 = cfg.replace(dtype="bfloat16")
    tree = jax.tree_util.tree_map(np.asarray, jp)
    conv = from_numpy_params(tree, bf16)
    node = TW.params_to(TW.prepare_params(conv, bf16), "cpu")["model"]["layers"]["self_attn"]["qkv_proj"]
    assert node["scales"].dtype == torch.bfloat16
    assert all(node[key].dtype == torch.float32 for key in ("lora_a", "lora_b", "lora_scale"))
    np.testing.assert_array_equal(node["lora_b"].numpy(), tree["model"]["layers"]["self_attn"]["qkv_proj"]["lora_b"])


def test_adapter_decode_step_has_no_host_sync(ckpt, tmp_path):
    """One captured single-stream decode step of a model with LoRA leaves
    (their layer's scale a 0-d device tensor): no host sync, and the step
    reads the LoRA leaves (its output moves with lora_b)."""
    cfg, tparams = TW.load_params(ckpt)
    write_adapter(str(tmp_path / "ad"), cfg, [0, 1])
    params = TW.load_adapter(TW.prepare_params(tparams, cfg), cfg, str(tmp_path / "ad"))
    lm = TE.LM(cfg, params, device="cpu")
    dec, _ = TE.prefill_decoder(lm, port_proc(ckpt)(PROMPT), 16)
    dec.ring.start(1)
    ops = _recorded(dec.graph.step)
    assert ops and not SYNCS & set(ops), sorted(SYNCS & set(ops))
    base = TE.LM(cfg, TW.prepare_params(TW.load_params(ckpt)[1], cfg), device="cpu")
    la = TE.run_prefill(lm, port_proc(ckpt)(PROMPT), 8)[0]
    lb = TE.run_prefill(base, port_proc(ckpt)(PROMPT), 8)[0]
    assert (la - lb).abs().max() > 1e-3


def port_proc(ckpt):
    from phi_3_vision_mlx_tpu_torch.models.preprocess import Phi3Processor

    return Phi3Processor(ckpt)


def test_export_table_matches_jax():
    """Every name the JAX package exports resolves in the port (``_WAITING``,
    the names still to port, is empty; ``benchmark`` and ``chat_ui`` are the
    port's own); importing the port and resolving its names loads no
    ``jax`` and initializes no CUDA."""
    assert set(JPKG._LAZY) == set(TPKG._LAZY) and TPKG._WAITING == {}
    for name in TPKG._LAZY:
        assert getattr(TPKG, name) is not None
    assert TPKG.benchmark.__module__ == "phi_3_vision_mlx_tpu_torch.bench"
    assert TPKG.chat_ui.__module__ == "phi_3_vision_mlx_tpu_torch.serve.ui"
    with pytest.raises(AttributeError, match="has no attribute"):
        TPKG.no_such_name  # noqa: B018
    assert set(TPKG._LAZY) <= set(dir(TPKG))
    code = ("import sys, torch, phi_3_vision_mlx_tpu_torch as pv\n"
            "[getattr(pv, n) for n in pv._LAZY]\n"
            "assert pv.ID_ASS == 32001 and callable(pv.train_lora) and pv.PATH_ADAPTERS == 'adapters'\n"
            "assert callable(pv.benchmark) and callable(pv.chat_ui)\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'phi_3_vision_mlx_tpu.'))]\n"
            "assert not bad and not torch.cuda.is_initialized(), bad\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
