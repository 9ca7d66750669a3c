"""8-bit weights: the port's layout, kernel K8's plain version, its checkpoint
writers and the 8-bit model against the JAX package.

Inputs come from ``np.random.default_rng`` and go to both packages.  K8's
plain version is held against the JAX XLA path (``ops/quant.py:
quantized_matmul`` on the plain uint8 payload) and against the JAX Pallas
kernel ``quant_matmul_interleaved``, run in interpret mode on the CPU through
a test-local stand-in for its module's ``pl`` (the JAX package's tests do not
run that kernel).  The JAX kernel widens its int8 payload as signed, so
levels >= 128 dequantize there as ``q - 256``: test (c) pins that fault
(ROADMAP queue 3), and the port computes the XLA path's function.

Tolerances: f32 outputs of O(1) whose sums run in another order, 1e-5; bf16
outputs, one bf16 rounding of O(1) values (2**-8 relative) plus the JAX
CPU's bf16 matmul, 1e-2; the interpret-mode kernel, which multiplies bf16 by
bf16 in its own order, 2e-2 as for K1-K7.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_batching import PLAN, _drive, continuous_servers_agree  # noqa: E402
from test_torch_model import FP32_ATOL, PROMPT, VOCAB, _generate, _prefill_logits, make_checkpoint  # noqa: E402

from phi_3_vision_mlx_tpu.api import _load as jax_load  # noqa: E402
from phi_3_vision_mlx_tpu.core import weights as JW  # noqa: E402
from phi_3_vision_mlx_tpu.engine.paging import PagedBatchEngine as JPaged  # noqa: E402
from phi_3_vision_mlx_tpu.ops import linear as JL  # noqa: E402
from phi_3_vision_mlx_tpu.ops import quant as JQ  # noqa: E402
from phi_3_vision_mlx_tpu.ops.kernels import quant_matmul as JK  # noqa: E402
from phi_3_vision_mlx_tpu_torch.api import _load as torch_load  # noqa: E402
from phi_3_vision_mlx_tpu_torch.core import weights as TW  # noqa: E402
from phi_3_vision_mlx_tpu_torch.core.config import QuantConfig, preset  # noqa: E402
from phi_3_vision_mlx_tpu_torch.engine.paging import PagedBatchEngine as TPaged  # noqa: E402
from phi_3_vision_mlx_tpu_torch.models import phi3 as TM  # noqa: E402
from phi_3_vision_mlx_tpu_torch.ops import linear as TL  # noqa: E402
from phi_3_vision_mlx_tpu_torch.ops.kernels import quant_matmul as TK  # noqa: E402
from test_torch_model import one_thread  # noqa: E402,F401  (autouse: one torch thread)

GROUP = 64
K, N = 512, 512  # the JAX interleaved kernel needs multiples of its 512 blocks
F32_TOL = 1e-5
BF16_TOL = 1e-2
KERNEL_TOL = 2e-2


def _affine8(seed, high=256, k=K, n=N, lead=()):
    """Random 8-bit levels in [0, high) with bf16-representable f32 scales
    and biases of an O(0.02) weight."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, high, (*lead, k, n), dtype=np.uint8)
    bf = lambda a: np.array(jnp.asarray(a, jnp.float32).astype(jnp.bfloat16).astype(jnp.float32))  # noqa: E731
    s = bf(0.04 / 255 * (1 + 0.1 * rng.standard_normal((*lead, k // GROUP, n))))
    b = bf(-0.02 + 0.001 * rng.standard_normal((*lead, k // GROUP, n)))
    return q, s, b


def _leaf(q, s, b):
    return TW.prepare_linear({"weight": torch.from_numpy(q), "scales": torch.from_numpy(s),
                              "biases": torch.from_numpy(b)}, bits=8)


def _x(seed, m, dtype):
    x = np.random.default_rng(seed).standard_normal((m, K)).astype(np.float32)
    xj = jnp.asarray(x).astype(dtype)
    return xj, torch.from_numpy(np.array(xj.astype(jnp.float32))).to(
        torch.float32 if dtype == jnp.float32 else torch.bfloat16)


def _xla(xj, q, s, b):
    """The JAX XLA path on payload ``q`` (uint8 or int8), f32 output."""
    return np.asarray(JQ.quantized_matmul(
        xj, JQ.QTensor(jnp.asarray(q), jnp.asarray(s), jnp.asarray(b))).astype(jnp.float32))


class _InterpretPallas:
    """The JAX kernel module's ``pl`` with ``pallas_call(interpret=True)``."""

    def __init__(self, pl):
        self._pl = pl

    def __getattr__(self, name):
        return getattr(self._pl, name)

    def pallas_call(self, *args, **kwargs):
        return self._pl.pallas_call(*args, interpret=True, **kwargs)


def _jax_k8(monkeypatch, xb, q, s, b):
    """The JAX K8 (``quant_matmul_interleaved``) in interpret mode, f32 out."""
    monkeypatch.setattr(JK, "pl", _InterpretPallas(JK.pl))
    q_perm, s32, b32 = JK.to_kernel_layout(jnp.asarray(q), jnp.asarray(s), jnp.asarray(b))
    out = JK.quant_matmul_interleaved(JK.permute_activation(xb, GROUP), q_perm, s32, b32,
                                      out_dtype=jnp.float32)
    monkeypatch.undo()
    return np.asarray(out)


# --- (a) K8's plain version against the JAX XLA path --------------------------


@pytest.mark.parametrize("m", [1, 3, 300])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k8_plain_matches_jax_xla_path(dtype, m):
    q, s, b = _affine8(0)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    xj, xt = _x(1, m, jd)
    leaf = _leaf(q, s, b)
    out = TK.quant_matmul_w8(xt, leaf["qweight"], leaf["scales"], leaf["biases"])
    assert out.dtype == xt.dtype and out.shape == (m, N)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(out.float().numpy(), _xla(xj, q, s, b), rtol=tol, atol=tol)


# --- (b) against the JAX kernel in interpret mode, levels < 128 ---------------


@pytest.mark.parametrize("m", [1, 3])
def test_k8_plain_matches_jax_interleaved_kernel_below_128(monkeypatch, m):
    q, s, b = _affine8(2, high=128)
    xb, xt = _x(3, m, jnp.bfloat16)
    ref = _jax_k8(monkeypatch, xb, q, s, b)
    assert JK.pl.__class__.__name__ != "_InterpretPallas"  # restored
    leaf = _leaf(q, s, b)
    out = TK.quant_matmul_w8(xt, leaf["qweight"], leaf["scales"], leaf["biases"], torch.float32)
    np.testing.assert_allclose(out.numpy(), ref, rtol=KERNEL_TOL, atol=KERNEL_TOL)


# --- (c) the JAX kernel's signed-cast fault, pinned ---------------------------


def test_jax_k8_signed_cast_fault_is_pinned(monkeypatch):
    """Levels over the full 0..255 range: the JAX K8 equals the XLA path on
    the wrapped payload ``q - 256`` (its int8 cast), the port equals the XLA
    path on the true payload, and the two functions differ by far more than
    rounding."""
    q, s, b = _affine8(4)
    assert (q >= 128).mean() > 0.4
    xb, xt = _x(5, 2, jnp.bfloat16)
    jax_kernel = _jax_k8(monkeypatch, xb, q, s, b)
    wrapped = _xla(xb, q.astype(np.int8), s, b)
    true = _xla(xb, q, s, b)
    np.testing.assert_allclose(jax_kernel, wrapped, rtol=KERNEL_TOL, atol=KERNEL_TOL)
    leaf = _leaf(q, s, b)
    port = TK.quant_matmul_w8(xt, leaf["qweight"], leaf["scales"], leaf["biases"], torch.float32)
    np.testing.assert_allclose(port.numpy(), true, rtol=BF16_TOL, atol=BF16_TOL)
    gap = float(np.abs(jax_kernel - true).max())
    assert gap > 50 * KERNEL_TOL, gap  # 1.49 here, on outputs of about 0.5


# --- (d) layout and prepare_params --------------------------------------------


def test_pack_int8_roundtrip_and_layout():
    q = np.random.default_rng(6).integers(0, 256, (3, 128, 40), dtype=np.uint8)
    words = TW.pack_int8(torch.from_numpy(q))
    assert words.dtype == torch.int32 and words.shape == (3, 32, 40)
    np.testing.assert_array_equal(TW.unpack_int8(words).numpy(), q)
    # byte j of word [r, n] holds q[4r + j, n], unsigned
    w0 = int(words[1, 5, 7]) & 0xFFFFFFFF
    assert [(w0 >> (8 * j)) & 255 for j in range(4)] == list(q[1, 20:24, 7])
    assert TW.leaf_bits(words, 128) == 8 and TW.leaf_bits(TW.pack_int4(torch.from_numpy(q & 15)), 128) == 4
    with pytest.raises(ValueError, match="no packed layout"):
        TW.leaf_bits(words, 64)


@pytest.fixture(scope="module")
def jax_raw(tmp_path_factory):
    """One JAX-written unquantized tiny checkpoint."""
    path = str(tmp_path_factory.mktemp("raw") / "raw")
    JW.create_random_checkpoint(path, "tiny", vocab_size=VOCAB)
    return path


def test_prepare_params_of_a_jax_8bit_checkpoint(jax_raw, tmp_path):
    JW.quantize_checkpoint(jax_raw, str(tmp_path), q_bits=8)
    cfg, params = TW.load_params(str(tmp_path))
    assert cfg.quantized == QuantConfig(GROUP, 8, "affine")
    raw = params["model"]["layers"]["mlp"]["down_proj"]
    prepared = TW.prepare_params(params, cfg)
    down = prepared["model"]["layers"]["mlp"]["down_proj"]
    nl, i, e = cfg.num_hidden_layers, cfg.intermediate_size, cfg.hidden_size
    assert down["qweight"].shape == (nl, i // 4, e) and down["qweight"].dtype == torch.int32
    assert down["scales"].dtype == down["biases"].dtype == torch.bfloat16
    assert torch.equal(TW.unpack_int8(down["qweight"]), raw["weight"])
    assert int(raw["weight"].max()) > 127  # the full unsigned range is in use
    lm_head = prepared["lm_head"]
    assert lm_head["qweight"].shape == (e // 4, VOCAB)
    emb = prepared["model"]["embed_tokens"]
    assert emb["weight"].dtype == torch.uint8 and emb["weight"].shape == (VOCAB, e)
    for bad in (QuantConfig(GROUP, 3, "affine"), QuantConfig(GROUP, 2, "affine")):
        with pytest.raises(NotImplementedError, match="4-bit and 8-bit"):
            TW.prepare_params(params, cfg.replace(quantized=bad))
    with pytest.raises(NotImplementedError, match="symmetric"):
        TW.prepare_linear({"weight": raw["weight"][0], "scales": raw["scales"][0]}, bits=8)


def test_dense_regimes_and_embedding_match_jax_8bit():
    """``dense`` below (K8) and above (dequantize + matmul) 256 rows, the
    stacked layer view, and the 8-bit embedding."""
    q, s, b = _affine8(7, lead=(2,))
    leaf = _leaf(q, s, b)
    for layer in (0, 1):
        jleaf = {"weight": jnp.asarray(q[layer]), "scales": jnp.asarray(s[layer]),
                 "biases": jnp.asarray(b[layer])}
        for rows in (7, 260):
            x = np.random.default_rng(rows).standard_normal((1, rows, K)).astype(np.float32)
            np.testing.assert_allclose(
                TL.dense_stacked(leaf, torch.from_numpy(x), layer).numpy(),
                np.asarray(JL.dense(jleaf, jnp.asarray(x))), rtol=F32_TOL, atol=F32_TOL)
    ids = np.array([[3, 0, 511, 3]])
    emb = {"weight": q[0].T.copy(), "scales": s[0].T.copy(), "biases": b[0].T.copy()}
    ref = JL.embedding({k: jnp.asarray(v) for k, v in emb.items()}, jnp.asarray(ids))
    out = TL.embedding({k: torch.from_numpy(v) for k, v in emb.items()}, torch.from_numpy(ids))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_synth_quantized_params_8bit():
    cfg = preset("tiny").replace(quantized=QuantConfig(GROUP, 8, "affine"))
    p = TW.synth_quantized_params(cfg, device="cpu", seed=0)
    qkv = p["model"]["layers"]["self_attn"]["qkv_proj"]
    e, d = cfg.hidden_size, cfg.head_dim
    op = (cfg.num_attention_heads + 2 * cfg.num_key_value_heads) * d
    assert qkv["qweight"].shape == (cfg.num_hidden_layers, e // 4, op)
    assert qkv["scales"].shape == qkv["biases"].shape == (cfg.num_hidden_layers, e // GROUP, op)
    assert p["lm_head"]["qweight"].shape == (e // 4, cfg.vocab_size)
    assert int(p["model"]["embed_tokens"]["weight"].max()) > 15
    # The weights span the 4-bit synthetic range: -0.03 to 0.03 at the
    # nominal scale, whose 10% jitter stretches the top to about 0.05.
    w = TW.unpack_int8(p["lm_head"]["qweight"]).float().reshape(e // GROUP, GROUP, -1)
    w = w * p["lm_head"]["scales"].float()[:, None] + p["lm_head"]["biases"].float()[:, None]
    assert -0.031 < float(w.min()) and float(w.max()) < 0.06 and abs(float(w.mean())) < 3e-3
    with pytest.raises(NotImplementedError, match="symmetric"):
        TW.synth_quantized_params(cfg.replace(quantized=QuantConfig(GROUP, 8, "symmetric")), "cpu")


# --- (e) quantize_checkpoint against the JAX one ------------------------------


@pytest.mark.parametrize("bits", [4, 8])
def test_quantize_checkpoint_matches_jax(jax_raw, tmp_path, bits):
    """The port's and the JAX ``quantize_checkpoint`` of one JAX-written raw
    checkpoint: same config, keys, dtypes, payloads, scales and biases
    (the same f32 arithmetic on both sides: no level differs), and each
    package loads the other's output."""
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    JW.quantize_checkpoint(jax_raw, jdir, q_bits=bits)
    cfg = TW.quantize_checkpoint(jax_raw, tdir, q_bits=bits)
    assert cfg.quantized == QuantConfig(GROUP, bits, "affine")
    with open(f"{jdir}/config.json") as f, open(f"{tdir}/config.json") as g:
        assert json.load(f) == json.load(g)
    jflat, tflat = TW.load_safetensors_dir(jdir), TW.load_safetensors_dir(tdir)
    assert jflat.keys() == tflat.keys()
    levels = 0
    for key, want in jflat.items():
        got = tflat[key]
        assert got.dtype == want.dtype and got.shape == want.shape, key
        if key.endswith(".weight") and want.dtype == torch.uint8:
            levels += want.numel()
        assert torch.equal(got, want), (key, int((got != want).sum()))
    assert levels > 0
    # Each package loads the other's checkpoint, to the same tensors.
    jcfg, jparams = JW.load_params(tdir)
    assert jcfg.quantized.bits == bits
    flat = JW.flatten_params(jparams)
    assert flat.keys() == JW.flatten_params(JW.load_params(jdir)[1]).keys()
    for key, arr in flat.items():
        np.testing.assert_array_equal(np.asarray(arr, np.float32), tflat[key].float().numpy())
    pcfg, pparams = TW.load_params(jdir)
    assert pcfg == cfg
    assert torch.equal(pparams["lm_head"]["weight"], tflat["lm_head.weight"])


# --- (f) init_params / create_random_checkpoint -------------------------------


def test_create_random_checkpoint_matches_jax_tree(jax_raw, tmp_path):
    """Same config, keys, shapes and dtypes as the JAX ``create_random_
    checkpoint`` (other numbers: ``torch.Generator`` is not ``jax.random``),
    the JAX law (normal, ``fan_in ** -0.5``; 0.02 for the embedding; unit
    norms), a seed that repeats, and the JAX package loads the result."""
    path = str(tmp_path / "port")
    cfg = TW.create_random_checkpoint(path, "tiny", seed=3, vocab_size=VOCAB)
    with open(f"{jax_raw}/config.json") as f, open(f"{path}/config.json") as g:
        assert json.load(f) == json.load(g)
    want, got = TW.load_safetensors_dir(jax_raw), TW.load_safetensors_dir(path)
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].dtype == want[key].dtype and got[key].shape == want[key].shape, key
    e, i = cfg.hidden_size, cfg.intermediate_size
    for key, scale in (("model.embed_tokens.weight", 0.02), ("lm_head.weight", e ** -0.5),
                       ("model.layers.1.self_attn.qkv_proj.weight", e ** -0.5),
                       ("model.layers.0.mlp.down_proj.weight", i ** -0.5)):
        t = got[key].double()
        assert abs(float(t.std()) / scale - 1) < 0.05 and abs(float(t.mean())) < 0.05 * scale, key
    assert torch.equal(got["model.norm.weight"], torch.ones(e))
    again = TW.create_random_checkpoint(str(tmp_path / "again"), "tiny", seed=3, vocab_size=VOCAB)
    assert again == cfg
    assert torch.equal(TW.load_safetensors_dir(str(tmp_path / "again"))["lm_head.weight"],
                       got["lm_head.weight"])
    jcfg, jparams = JW.load_params(path)
    assert jcfg == JW.load_params(jax_raw)[0]
    jtree = jax.tree_util.tree_map(lambda a: (a.shape, str(a.dtype)), jparams)
    ttree = TW.load_params(path)[1]
    assert jtree == jax.tree_util.tree_map(lambda a: (tuple(a.shape), str(a.dtype).split(".")[1]),
                                           ttree)
    vdir = str(tmp_path / "v")
    vcfg = TW.create_random_checkpoint(vdir, "tiny_vision", vocab_size=VOCAB)
    assert vcfg.has_vision
    vtree = JW.load_params(vdir)[1]["model"]["vision_embed_tokens"]
    assert jax.tree_util.tree_map(lambda a: (a.shape, str(a.dtype)), vtree) == jax.tree_util.tree_map(
        lambda a: (tuple(a.shape), str(a.dtype).split(".")[1]), TW.load_params(vdir)[1]["model"]["vision_embed_tokens"])


def test_init_params_tree_matches_jax():
    from phi_3_vision_mlx_tpu.models.phi3 import init_params as jax_init

    cfg = preset("tiny", vocab_size=VOCAB)
    from phi_3_vision_mlx_tpu.core.config import preset as jax_preset

    jtree = jax_init(jax_preset("tiny", vocab_size=VOCAB), jax.random.PRNGKey(0))
    for dtype, name in ((None, "float32"), (torch.bfloat16, "bfloat16")):
        ttree = TM.init_params(cfg, torch.Generator().manual_seed(0), dtype=dtype)
        shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), jtree)
        assert shapes == jax.tree_util.tree_map(lambda a: tuple(a.shape), ttree)
        assert all(str(a.dtype) == f"torch.{name}" for a in jax.tree_util.tree_leaves(ttree))


# --- (g) the 8-bit model against the JAX package ------------------------------


@pytest.fixture(scope="module")
def w8_path(tmp_path_factory):
    return make_checkpoint(tmp_path_factory.mktemp("ckpt8"), "tiny8", q_bits=8)


@pytest.fixture(scope="module")
def w8_pair(w8_path):
    pair = jax_load(w8_path), torch_load(w8_path, device="cpu")
    qkv = pair[1][0].params["model"]["layers"]["self_attn"]["qkv_proj"]["qweight"]
    assert qkv.shape[-2] * 4 == pair[1][0].cfg.hidden_size  # K8's layout
    return pair


def test_8bit_prefill_logits_fp32_match_jax(w8_pair):
    jl, tl, _, _ = _prefill_logits(w8_pair, PROMPT, 16)
    assert tl.shape == jl.shape == (1, VOCAB)
    np.testing.assert_allclose(tl, jl, rtol=0, atol=FP32_ATOL)


@pytest.mark.parametrize("prompt", [PROMPT, ["Hi", "A longer second prompt."]], ids=["single", "batch"])
def test_8bit_greedy_tokens_identical_fp32(w8_pair, prompt):
    jout, tout = _generate(w8_pair, prompt, 16)
    assert tout == jout
    assert all(len(t) > 0 for t in tout)


def test_8bit_bf16_logits_close_to_jax(tmp_path_factory):
    """As tests/test_torch_model.py:test_bf16_logits_close_to_jax, 8-bit."""
    path = make_checkpoint(tmp_path_factory.mktemp("ckpt8_16"), "tiny8_16", q_bits=8,
                           dtype="bfloat16")
    pair = (jax_load(path), torch_load(path, device="cpu"))
    jl, tl, _, _ = _prefill_logits(pair, PROMPT, 16)
    rel = np.linalg.norm(tl - jl) / np.linalg.norm(jl)
    assert rel < 3e-2, rel
    assert np.argmax(jl[0]) in set(np.argsort(tl[0])[-5:])


def test_8bit_paged_engine_matches_jax(w8_pair):
    (jlm, jproc), (tlm, tproc) = w8_pair
    want = _drive(JPaged(jlm, jproc, slots=3, window=256, page_size=32), PLAN)
    got = _drive(TPaged(tlm, tproc, slots=3, window=256, page_size=32), PLAN)
    assert got == want and all(len(t) > 4 for t in got)


def test_8bit_continuous_server_matches_jax_server(w8_pair):
    continuous_servers_agree(w8_pair)


def test_port_written_8bit_checkpoint_serves_the_jax_text(jax_raw, tmp_path):
    """The port quantizes a raw checkpoint to 8 bits; the JAX package and the
    port load that directory and generate the same text (fp32)."""
    TW.quantize_checkpoint(jax_raw, str(tmp_path), q_bits=8)
    pair = jax_load(str(tmp_path)), torch_load(str(tmp_path), device="cpu")
    jout, tout = _generate(pair, PROMPT, 12)
    assert tout == jout


# --- (h) generate(quantize_cache=True) ----------------------------------------


def test_generate_quantize_cache_reaches_the_int4_cache(w8_path, tmp_path, monkeypatch):
    """``api.generate`` without ``preload`` loads with ``quantize_cache`` and
    decodes over the int4 cache (K4/K5's routes), as ``_load(...,
    use_quantized_cache=True)`` does."""
    from phi_3_vision_mlx_tpu_torch import api

    loaded, calls = [], {"K4": 0, "K5": 0}
    real_load = api.load

    def load_on_cpu(**kw):
        loaded.append(real_load(device="cpu", **kw))
        return loaded[-1]

    def counting(name, fn):
        def wrapper(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapper

    monkeypatch.setattr(api, "load", load_on_cpu)
    monkeypatch.setattr(TM, "quantized_kv_attention", counting("K4", TM.quantized_kv_attention))
    monkeypatch.setattr(TM, "quantized_flash_attention", counting("K5", TM.quantized_flash_attention))
    monkeypatch.chdir(tmp_path)
    os.makedirs("models")
    for path in (api.PATH_ORIGINAL_PHI3_BLIND, api.PATH_QUANTIZED_PHI3_BLIND):
        os.symlink(w8_path, path)
    kw = dict(max_tokens=8, verbose=False, stream=False, mute=True)
    got = api.generate("Hi", blind_model=True, quantize_cache=True, **kw)
    assert loaded[-1][0].cfg.use_quantized_cache and loaded[-1][0].cfg.kv_quant.bits == 4
    assert calls["K4"] > 0 and calls["K5"] > 0
    assert got == api.generate("Hi", preload=torch_load(w8_path, device="cpu", use_quantized_cache=True),
                               **kw)
    api.generate("Hi", blind_model=True, **kw)
    assert not loaded[-1][0].cfg.use_quantized_cache


# --- (i) no fallback ----------------------------------------------------------


def test_k8_wrapper_has_no_silent_fallback():
    """A tensor that is neither on the CPU nor on CUDA raises, as do
    shapes K8 does not take; the plain version runs only for CPU tensors."""
    meta = dict(dtype=torch.bfloat16, device="meta")
    x = torch.empty((1, K), **meta)
    qw = torch.empty((K // 4, N), dtype=torch.int32, device="meta")
    s = torch.empty((K // GROUP, N), **meta)
    with pytest.raises(RuntimeError, match="no kernel"):
        TK.quant_matmul_w8(x, qw, s, s)
    with pytest.raises(ValueError, match="affine"):
        TK.quant_matmul_w8(x, qw, s, None)
    with pytest.raises(ValueError, match="do not match"):
        TK.quant_matmul_w8(x, torch.empty((K // 8, N), dtype=torch.int32, device="meta"), s, s)
    assert TK.quant_matmul_w8.launches == 0 and TK.quant_matmul.launches == 0
