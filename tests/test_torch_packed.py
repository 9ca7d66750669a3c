"""The flat packed 4-bit layout on the port: its layout functions, kernel K9's
plain version (K10 is K9 on a ``w[layer]`` view), ``dense``'s dispatch,
``prepare_params``'s handling of such a leaf, and a model served from packed
leaves, against the JAX package.

Inputs come from ``np.random.default_rng`` and go to both packages.  The JAX
packed kernels (``quant_matmul_packed``, ``quant_matmul_packed_stacked``)
have no ``interpret`` argument, so they run in interpret mode through a
test-local stand-in for their module's ``pl`` (as in ``tests/
test_torch_w8.py``).

Tolerances: f32 outputs of O(1), sums in another order, 1e-5; the
interpret-mode kernels, which multiply bf16 x by bf16 W with f32
accumulation as the port does but in their own block order, 1e-2; the model
as in ``tests/test_torch_model.py`` (fp32 logits 1e-4, 16 greedy tokens
identical; bf16 logits within 3% relative L2).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_model import FP32_ATOL, PROMPT, VOCAB, _generate, _prefill_logits, make_checkpoint  # noqa: E402
from test_torch_w8 import _InterpretPallas  # noqa: E402

from phi_3_vision_mlx_tpu.api import _load as jax_load  # noqa: E402
from phi_3_vision_mlx_tpu.engine import engine as JE  # noqa: E402
from phi_3_vision_mlx_tpu.ops import linear as JL  # noqa: E402
from phi_3_vision_mlx_tpu.ops.kernels import quant_matmul as JK  # noqa: E402
from phi_3_vision_mlx_tpu_torch.api import _load as torch_load  # noqa: E402
from phi_3_vision_mlx_tpu_torch.core import weights as TW  # noqa: E402
from phi_3_vision_mlx_tpu_torch.core.config import QuantConfig, preset  # noqa: E402
from phi_3_vision_mlx_tpu_torch.core.convert import from_numpy_params  # noqa: E402
from phi_3_vision_mlx_tpu_torch.engine.engine import LM  # noqa: E402
from phi_3_vision_mlx_tpu_torch.ops import linear as TL  # noqa: E402
from phi_3_vision_mlx_tpu_torch.ops.kernels import quant_matmul as TK  # noqa: E402
from test_torch_model import one_thread  # noqa: E402,F401  (autouse: one torch thread)

GROUP = 64
F32_TOL = 1e-5
KERNEL_TOL = 1e-2
CFG4 = preset("tiny").replace(quantized=QuantConfig(GROUP, 4, "affine"))


def _bf(a):
    """Round an f32 array to bf16-representable values."""
    return np.array(jnp.asarray(a, jnp.float32).astype(jnp.bfloat16).astype(jnp.float32))


def _affine4(seed, k, n, lead=()):
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 16, (*lead, k, n), dtype=np.uint8)
    s = _bf(0.004 * (1 + 0.1 * rng.standard_normal((*lead, k // GROUP, n))))
    b = _bf(-0.03 + 0.001 * rng.standard_normal((*lead, k // GROUP, n)))
    return q, s, b


def _jax_packed(q):
    """The JAX package's packed payload of plain levels ``q`` (..., K, N)."""
    k = q.shape[-2]
    perm = JK._perm_for(k, GROUP, min(JK.BLOCK_K, k))
    flat = q.reshape(-1, k, q.shape[-1])
    return np.stack([np.asarray(JK.pack_nibbles(jnp.asarray(m)[perm])) for m in flat]).reshape(
        *q.shape[:-1], q.shape[-1] // 2)


def _packed_leaf(q, s, b):
    return {"weight": TW.to_packed_layout(torch.from_numpy(q)), "scales": torch.from_numpy(s).to(torch.bfloat16),
            "biases": torch.from_numpy(b).to(torch.bfloat16)}


def _x(seed, m, k, dtype):
    x = np.random.default_rng(seed).standard_normal((m, k)).astype(np.float32)
    xj = jnp.asarray(x).astype(dtype)
    return xj, torch.from_numpy(np.array(xj.astype(jnp.float32))).to(
        torch.float32 if dtype == jnp.float32 else torch.bfloat16)


# --- (a) the layout, byte for byte --------------------------------------------


@pytest.mark.parametrize("k", [256, 512, 1024])
def test_packed_layout_matches_jax_byte_for_byte(k):
    """``to_packed_layout`` equals JAX ``pack_nibbles(q[_perm_for(...)])``,
    stacked leading dims included; ``from_packed_layout`` equals JAX
    ``unpermute_payload(unpack_nibbles(...))`` and inverts it."""
    q = np.random.default_rng(k).integers(0, 16, (2, k, 1024), dtype=np.uint8)
    want = _jax_packed(q)
    got = TW.to_packed_layout(torch.from_numpy(q))
    assert got.dtype == torch.uint8 and got.shape == (2, k, 512)
    np.testing.assert_array_equal(got.numpy(), want)
    back = TW.from_packed_layout(got)
    np.testing.assert_array_equal(back.numpy(), q)
    jback = np.asarray(JK.unpermute_payload(JK.unpack_nibbles(jnp.asarray(want[1]))))
    np.testing.assert_array_equal(back[1].numpy(), jback)
    # row i * gk + gl of a block holds original row gl * 64 + i (gk = block_k / 64)
    gk = min(512, k) // GROUP
    assert torch.equal(TW.packed_row_perm(k)[: 2 * gk : gk], torch.tensor([0, 1]))
    with pytest.raises(ValueError, match="packed layout"):
        TW.to_packed_layout(torch.from_numpy(q[..., :1000]))


# --- (b) plain K9 against the JAX packed kernels (interpret mode) -------------


@pytest.mark.parametrize("m", [1, 3])
def test_k9_plain_matches_jax_packed_kernel(monkeypatch, m):
    q, s, b = _affine4(1, 1024, 1024)
    xb, xt = _x(2, m, 1024, jnp.bfloat16)
    monkeypatch.setattr(JK, "pl", _InterpretPallas(JK.pl))
    ref = np.asarray(JK.quant_matmul_packed(JK.permute_activation(xb, GROUP), jnp.asarray(_jax_packed(q)),
                                            jnp.asarray(s), jnp.asarray(b), out_dtype=jnp.float32))
    monkeypatch.undo()
    leaf = _packed_leaf(q, s, b)
    out = TK.quant_matmul_packed(xt, leaf["weight"], leaf["scales"], leaf["biases"], torch.float32)
    assert out.shape == (m, 1024) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=KERNEL_TOL, atol=KERNEL_TOL)


@pytest.mark.parametrize("layer", [0, 1])
def test_k9_plain_on_a_layer_view_matches_jax_packed_stacked_kernel(monkeypatch, layer):
    """K10: the JAX stacked kernel selects the layer by scalar prefetch; the
    port's wrapper takes the zero-copy ``w[layer]`` view."""
    q, s, b = _affine4(3, 512, 1024, lead=(2,))
    xb, xt = _x(4, 2, 512, jnp.bfloat16)
    monkeypatch.setattr(JK, "pl", _InterpretPallas(JK.pl))
    ref = np.asarray(JK.quant_matmul_packed_stacked(
        JK.permute_activation(xb, GROUP), jnp.asarray(_jax_packed(q)), jnp.asarray(s), jnp.asarray(b),
        layer, out_dtype=jnp.float32))
    monkeypatch.undo()
    leaf = TL.layer_view(_packed_leaf(q, s, b), layer)
    assert leaf["weight"].is_contiguous()
    out = TK.quant_matmul_packed(xt, leaf["weight"], leaf["scales"], leaf["biases"], torch.float32)
    np.testing.assert_allclose(out.numpy(), ref, rtol=KERNEL_TOL, atol=KERNEL_TOL)


# --- (c) plain K9 against the JAX XLA path, and dense's dispatch --------------


@pytest.mark.parametrize("m", [1, 300])
def test_k9_plain_matches_jax_xla_path_f32(m):
    """The JAX ``dense`` on a packed leaf above 256 rows is the XLA path
    (unpack, unpermute, dequantize, matmul): plain K9 equals it in f32."""
    q, s, b = _affine4(5, 1024, 1024)
    xj, xt = _x(6, 300, 1024, jnp.float32)
    want = np.asarray(JL.dense({"weight": jnp.asarray(_jax_packed(q)), "scales": jnp.asarray(s),
                                "biases": jnp.asarray(b)}, xj))[:m]
    leaf = _packed_leaf(q, s, b)
    out = TK.quant_matmul_packed(xt[:m], leaf["weight"], leaf["scales"].float(), leaf["biases"].float())
    np.testing.assert_allclose(out.numpy(), want, rtol=F32_TOL, atol=F32_TOL)


def test_dense_and_dense_stacked_on_a_packed_leaf():
    """The port's ``dense`` / ``dense_stacked`` on a packed leaf, below (K9)
    and above (unpack + dequantize + matmul) 256 rows, against the JAX
    ``dense`` on the plain leaf of the same weights, f32, per layer."""
    q, s, b = _affine4(7, 512, 1024, lead=(2,))
    leaf = _packed_leaf(q, s, b)
    leaf = {**leaf, "scales": leaf["scales"].float(), "biases": leaf["biases"].float()}
    for layer in (0, 1):
        jleaf = {"weight": jnp.asarray(q[layer]), "scales": jnp.asarray(s[layer]),
                 "biases": jnp.asarray(b[layer])}
        for rows in (7, 256, 260):
            x = np.random.default_rng(rows).standard_normal((1, rows, 512)).astype(np.float32)
            want = np.asarray(JL.dense(jleaf, jnp.asarray(x)))
            got = TL.dense_stacked(leaf, torch.from_numpy(x), layer)
            assert got.shape == (1, rows, 1024)
            np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL, atol=F32_TOL)


# --- (d) the repair: prepare_params and from_numpy_params keep a packed leaf --


def test_prepare_params_keeps_a_packed_linear_leaf():
    """A packed linear leaf, ``(K, N/2)`` uint8 beside ``(K/64, N)`` scales,
    is a linear (the JAX rule), not an embedding: ``prepare_params`` and
    ``from_numpy_params`` keep its payload, and ``dense`` gives the JAX
    ``dense`` of that leaf.  (The parent classified it by ``scales.shape[-1]
    == weight.shape[-1]`` as an embedding, and ``dense`` then multiplied the
    uint8 bytes as a (K, N/2) full-precision matrix.)"""
    q, s, b = _affine4(8, 512, 1024)
    packed = _jax_packed(q)
    x = np.random.default_rng(9).standard_normal((300, 512)).astype(np.float32)
    want = np.asarray(JL.dense({"weight": jnp.asarray(packed), "scales": jnp.asarray(s),
                                "biases": jnp.asarray(b)}, jnp.asarray(x)))
    tree = {"lin": {"weight": packed, "scales": s, "biases": b}, "norm": {"weight": np.ones(4, np.float32)}}
    via_torch = TW.prepare_params({"lin": {k: torch.from_numpy(v) for k, v in tree["lin"].items()}}, CFG4)
    via_numpy = from_numpy_params(tree, CFG4)
    for prepared in (via_torch["lin"], via_numpy["lin"]):
        assert TW.is_packed_leaf(prepared) and "qweight" not in prepared
        np.testing.assert_array_equal(prepared["weight"].numpy(), packed)
        assert prepared["scales"].dtype == prepared["biases"].dtype == torch.bfloat16
        for rows in (3, 300):
            got = TL.dense(prepared, torch.from_numpy(x[:rows]))
            assert got.shape == (rows, 1024)
            np.testing.assert_allclose(got.numpy(), want[:rows], rtol=F32_TOL, atol=F32_TOL)
    with pytest.raises(ValueError, match="4-bit affine"):
        TW.prepare_params({"lin": {k: torch.from_numpy(v) for k, v in tree["lin"].items()}},
                          CFG4.replace(quantized=QuantConfig(GROUP, 8, "affine")))


# --- (e) packed_params --------------------------------------------------------


def test_packed_params_moves_eligible_linears_only():
    """Every decoder linear of a preset whose (K, N) the layout takes is
    packed (the same levels, scales and biases); lm_head (N = 32064) keeps
    K1's layout; 8-bit or symmetric weights raise."""
    cfg = preset("tiny", hidden_size=512, intermediate_size=1024, vocab_size=VOCAB).replace(
        quantized=QuantConfig(GROUP, 4, "affine"))
    params = TW.synth_quantized_params(cfg, device="cpu", seed=0)
    packed = TW.packed_params(params, cfg)
    layers, plain_layers = packed["model"]["layers"], params["model"]["layers"]
    for block, name in (("self_attn", "qkv_proj"), ("self_attn", "o_proj"), ("mlp", "gate_up_proj"),
                        ("mlp", "down_proj")):
        leaf, orig = layers[block][name], plain_layers[block][name]
        k, n = orig["qweight"].shape[-2] * 8, orig["qweight"].shape[-1]
        assert leaf["weight"].shape == (cfg.num_hidden_layers, k, n // 2) and TW.is_packed_leaf(leaf)
        assert torch.equal(TW.from_packed_layout(leaf["weight"]), TW.unpack_int4(orig["qweight"]))
        assert leaf["scales"] is orig["scales"] and leaf["biases"] is orig["biases"]
    assert packed["lm_head"] is params["lm_head"] and "qweight" in packed["lm_head"]
    for bad in (QuantConfig(GROUP, 8, "affine"), QuantConfig(GROUP, 4, "symmetric")):
        with pytest.raises(ValueError, match="4-bit affine"):
            TW.packed_params(params, cfg.replace(quantized=bad))


def test_k9_wrapper_has_no_silent_fallback():
    """A tensor neither on the CPU nor on CUDA raises, as do a missing bias
    plane and shapes K9 does not take; the plain version runs only for CPU
    tensors."""
    meta = dict(dtype=torch.bfloat16, device="meta")
    x = torch.empty((1, 512), **meta)
    w = torch.empty((512, 512), dtype=torch.uint8, device="meta")
    s = torch.empty((512 // GROUP, 1024), **meta)
    with pytest.raises(RuntimeError, match="no kernel"):
        TK.quant_matmul_packed(x, w, s, s)
    with pytest.raises(ValueError, match="affine"):
        TK.quant_matmul_packed(x, w, s, None)
    with pytest.raises(ValueError, match="do not match"):
        TK.quant_matmul_packed(x, w[:256], s, s)
    assert TK.quant_matmul_packed.launches == 0


# --- (f) a model served from packed leaves -------------------------------------

PACKED_OVERRIDES = dict(hidden_size=512, intermediate_size=1024)  # every decoder linear packs


@pytest.fixture(scope="module")
def packed_pair(tmp_path_factory):
    """The JAX model on the plain layout and the port's model on packed
    leaves, both from one JAX-written fp32 checkpoint."""
    path = make_checkpoint(tmp_path_factory.mktemp("ckpt_packed"), "tiny512", **PACKED_OVERRIDES)
    (jlm, jproc), (tlm, tproc) = jax_load(path), torch_load(path, device="cpu")
    packed = TW.packed_params(tlm.params, tlm.cfg)
    assert TW.is_packed_leaf(packed["model"]["layers"]["mlp"]["down_proj"])
    return (jlm, jproc), (LM(tlm.cfg, packed, device="cpu"), tproc)


def test_packed_model_prefill_logits_fp32_match_jax(packed_pair):
    jl, tl, _, _ = _prefill_logits(packed_pair, PROMPT, 16)
    assert tl.shape == jl.shape == (1, VOCAB)
    np.testing.assert_allclose(tl, jl, rtol=0, atol=FP32_ATOL)


@pytest.mark.parametrize("prompt", [PROMPT, ["Hi", "A longer second prompt."]], ids=["single", "batch"])
def test_packed_model_greedy_tokens_identical_fp32(packed_pair, prompt):
    jout, tout = _generate(packed_pair, prompt, 16)
    assert tout == jout
    assert all(len(t) > 0 for t in tout)


def test_packed_model_bf16_close_to_the_jax_packed_kernels(tmp_path_factory, monkeypatch):
    """bf16: the JAX model holding the same packed leaves, whose prefill runs
    the JAX packed stacked kernel (interpret mode) on every decoder linear,
    against the port's model on them (plain K9 on the CPU)."""
    path = make_checkpoint(tmp_path_factory.mktemp("ckpt_packed16"), "tiny512_16", dtype="bfloat16",
                           **PACKED_OVERRIDES)
    (jlm, jproc), (tlm, tproc) = jax_load(path), torch_load(path, device="cpu")
    packed = TW.packed_params(tlm.params, tlm.cfg)

    def to_jax(node):
        if isinstance(node, dict):
            return {k: to_jax(v) for k, v in node.items()}
        return jnp.asarray(node.float().numpy()).astype(jnp.bfloat16) if node.is_floating_point() \
            else jnp.asarray(node.numpy())

    jparams = dict(jlm.params)
    jparams["model"] = {**jlm.params["model"], "layers": {
        **jlm.params["model"]["layers"],
        **{blk: {**jlm.params["model"]["layers"][blk],
                 **{name: to_jax(leaf) for name, leaf in packed["model"]["layers"][blk].items()
                    if isinstance(leaf, dict) and "weight" in leaf and TW.is_packed_leaf(leaf)}}
           for blk in ("self_attn", "mlp")}}}
    calls = []
    real = JK.quant_matmul_packed_stacked

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(JK, "pl", _InterpretPallas(JK.pl))
    monkeypatch.setattr(JK, "quant_matmul_packed_stacked", counted)
    jl, tl, _, _ = _prefill_logits(((JE.LM(jlm.cfg, jparams), jproc), (LM(tlm.cfg, packed, device="cpu"), tproc)),
                                   PROMPT, 16)
    assert calls, "the JAX model did not reach its packed kernel"
    rel = np.linalg.norm(tl - jl) / np.linalg.norm(jl)
    assert rel < 3e-2, rel
    assert np.argmax(jl[0]) in set(np.argsort(tl[0])[-5:])


# --- K9 as the card computes it (csrc/quant_matmul.cu), modelled in plain
# PyTorch; route B shares K1's model (tests/test_torch_quant.py) -------------

from test_torch_quant import MODEL_TOL, _route_b_model  # noqa: E402

from phi_3_vision_mlx_tpu_torch.ops.quant import QTensor, dequantize  # noqa: E402


# (K, N): an odd number of 512-column blocks (route B's 128-column tiles
# cross them), 128 groups (down_proj's K = 8192), block_k = K = 256 (gk = 4).
K9_MODEL_SHAPES = {"odd-blocks": (512, 1536), "128-groups": (8192, 512), "block-k-256": (256, 1024)}


@pytest.mark.parametrize("m", [1, 4, 8, 16, 17, 70])
@pytest.mark.parametrize("shape", list(K9_MODEL_SHAPES))
def test_k9_route_b_model_matches_plain(shape, m):
    """K9's route B: PackedTiles' B fragments (two byte columns a thread,
    low nibbles columns j = 0, 1, high j = 2, 3, rows in k order through the
    group interleave) are ``dequantize``'s bf16 W bit for bit, and the tile
    walk equals the plain version in f32."""
    k, n = K9_MODEL_SHAPES[shape]
    q, s, b = (torch.from_numpy(a) for a in _affine4(40 + m + len(shape), k, n))
    s, b = s.to(torch.bfloat16), b.to(torch.bfloat16)
    packed = TW.to_packed_layout(q)
    x = _x(m, m, k, jnp.bfloat16)[1]
    w_ref = dequantize(QTensor(q, s, b), dtype=torch.bfloat16)
    out = _route_b_model(x, "k9", packed, s, b, w_ref)
    ref = TK.quant_matmul_packed_plain(x, packed, s, b, torch.float32)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), **MODEL_TOL)
