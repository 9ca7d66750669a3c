"""The port's quantized KV cache (``engine/state.py``) and the plain versions
of kernels K4 and K5 (``ops/kernels/kv_attention.py``) against the JAX
package on the CPU.

Both packages quantize the same numpy-made k/v; the JAX cache (transposed,
head dim permuted) reaches the port's layout through
``core/convert.py:from_jax_kv_cache``.  The JAX kernels run in interpret
mode, as ``tests/test_quant_kernels.py`` runs them, and the JAX XLA path is
``read_kv`` + ``masked_attention``.  D = 96 (three groups of 32) is covered
beside D = 32 (one group), since one group cannot show a group or
permutation mistake.  At the end, the exactness the kernels' dequantization
rests on, and a plain-PyTorch model of the card's K5 (its int4 tiles and K2's
tile walk over them) held to the plain version.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from test_torch_attention import F32_TOL, _k2_tile_model  # noqa: E402

from phi_3_vision_mlx_tpu.core.config import KVQuantConfig, preset  # noqa: E402
from phi_3_vision_mlx_tpu.engine import state as JS  # noqa: E402
from phi_3_vision_mlx_tpu.ops.attention import masked_attention  # noqa: E402
from phi_3_vision_mlx_tpu.ops.kernels import kv_attention as JK  # noqa: E402
from phi_3_vision_mlx_tpu_torch.core.convert import d_perm, from_jax_kv_cache  # noqa: E402
from phi_3_vision_mlx_tpu_torch.engine import state as TS  # noqa: E402
from phi_3_vision_mlx_tpu_torch.ops.kernels import kv_attention as TK  # noqa: E402

# The TPU kernels round dequantized values to bf16 and factor the bias out of
# the dot products; the plain versions dequantize in f32.  The JAX package's
# own kernel tests hold its kernels to the XLA path at the same 2e-2.
KERNEL_TOL = dict(rtol=2e-2, atol=2e-2)


def _kv(seed, shape):
    """k and v off zero mean, so the bias planes carry signal."""
    rng = np.random.default_rng(seed)
    k = (rng.standard_normal(shape) * 1.5 + 0.7).astype(np.float32)
    v = (rng.standard_normal(shape) - 0.4).astype(np.float32)
    return k, v


def _jax_cache(k, v, bits=4):
    """JAX quantize_chunk -> (JAX payload, JAX scales, port payload, port scales)."""
    e = JS.quantize_chunk(jnp.asarray(k), jnp.asarray(v), KVQuantConfig(bits=bits), True)
    payload, scales = from_jax_kv_cache(np.asarray(e.k), np.asarray(e.k_scales.astype(jnp.float32)), bits)
    return e.k, e.k_scales, payload, scales


def _valid(b, w, pad, end):
    valid = np.zeros((b, w), bool)
    valid[:, pad:end] = True  # left padding, positions past `end` unwritten
    valid[:, pad + 3] = False  # an attention-dropped position
    return valid


def _xla(q, jpayload, jscales, layer, valid, q_pos, bits=4):
    """The JAX XLA path: read_kv of the layer in f32, then masked_attention."""
    kc, vc = JS.read_kv(JS.LayerKV(k=jpayload[layer], k_scales=jscales[layer]), jnp.float32, bits)
    w = valid.shape[1]
    allowed = (np.arange(w)[None, :] <= q_pos[:, None])[None, None] & valid[:, None, None, :]
    return np.asarray(masked_attention(jnp.asarray(q), kc, vc, jnp.asarray(allowed), q.shape[-1] ** -0.5))


@pytest.mark.parametrize("d", [32, 96])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits", [4, 8])
def test_quantize_chunk_bit_for_bit(bits, dtype, d):
    """The port's payload bytes and bf16 planes equal the JAX package's after
    the converter, including a constant group (scale 0 -> 1)."""
    k, v = _kv(bits + d, (2, 2, 3, 40, d))
    k[0, 0, 0, 0, :32] = 1.25
    kt, vt = torch.from_numpy(k), torch.from_numpy(v)
    if dtype == "bfloat16":
        kt, vt = kt.to(torch.bfloat16), vt.to(torch.bfloat16)
        k, v = kt.float().numpy(), vt.float().numpy()  # the same bf16 values for JAX
    e = JS.quantize_chunk(jnp.asarray(k).astype(dtype), jnp.asarray(v).astype(dtype),
                          KVQuantConfig(bits=bits), True)
    want_p, want_s = from_jax_kv_cache(np.asarray(e.k), np.asarray(e.k_scales.astype(jnp.float32)), bits)
    payload, scales = TS.quantize_chunk(kt, vt, KVQuantConfig(bits=bits))
    assert payload.dtype == torch.uint8 and scales.dtype == torch.bfloat16
    assert payload.shape == (2, 2, 3, 40, d if bits == 4 else 2 * d)
    assert scales.shape == (2, 2, 3, 40, 4 * (d // 32))
    assert torch.equal(payload, want_p)
    assert torch.equal(scales, want_s)


@pytest.mark.parametrize("d", [32, 96])
@pytest.mark.parametrize("bits", [4, 8])
def test_read_kv_matches_jax(bits, d):
    """The dequantized window equals the JAX ``read_kv``: exact in f32, and
    in bf16 (one rounding of the same f32 value)."""
    jp, js, payload, scales = _jax_cache(*_kv(d, (2, 1, 2, 64, d)), bits)
    for layer in range(2):
        for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
            jk, jv = JS.read_kv(JS.LayerKV(k=jp[layer], k_scales=js[layer]), jdt, bits)
            tk, tv = TS.dequantize_kv(payload[layer], scales[layer], tdt, bits)
            np.testing.assert_array_equal(tk.float().numpy(), np.asarray(jk.astype(jnp.float32)))
            np.testing.assert_array_equal(tv.float().numpy(), np.asarray(jv.astype(jnp.float32)))


def test_state_layout_and_in_place_write():
    """init_state allocates the port's token-major layout; a chunk written
    at an offset lands in its positions of its layer only."""
    cfg = preset("tiny", hidden_size=192, num_attention_heads=2, num_key_value_heads=1,
                 use_quantized_cache=True)
    st = TS.init_state(cfg, 2, 8, 32, compute_dtype=torch.float32)
    assert st.quantized and st.v is None
    assert st.k.shape == (2, 2, 1, 32, 96) and st.k.dtype == torch.uint8
    assert st.k_scales.shape == (2, 2, 1, 32, 12) and st.k_scales.dtype == torch.bfloat16
    st8 = TS.init_state(cfg.replace(kv_quant=KVQuantConfig(bits=8)), 2, 8, 32)
    assert st8.k.shape == (2, 2, 1, 32, 192)
    with pytest.raises(ValueError, match="does not fit"):
        TS.init_state(cfg.replace(kv_quant=KVQuantConfig(bits=3)), 2, 8, 32)
    k, v = (torch.from_numpy(a) for a in _kv(1, (2, 1, 3, 96)))
    TS.update_layer_chunk(st, 1, 5, k, v)
    payload, scales = TS.quantize_chunk(k, v, cfg.kv_quant)
    assert torch.equal(st.k[1, :, :, 5:8], payload) and torch.equal(st.k_scales[1, :, :, 5:8], scales)
    assert not st.k[0].any() and not st.k[1, :, :, :5].any() and not st.k[1, :, :, 8:].any()
    tk, tv = TS.read_kv(st, 1, torch.float32)
    assert tk.shape == tv.shape == (2, 1, 32, 96)


@pytest.mark.parametrize("d", [32, 96])
@pytest.mark.parametrize("lq", [1, 3])
def test_quantized_kv_plain_matches_jax_kernel(lq, d):
    """Plain K4 against the JAX kernel (interpret mode) and the JAX XLA path:
    decode at offset 100 over two layers of a stacked cache, read by index,
    with left padding and a dropped ``valid`` bit."""
    b, h, kvh, w, off = 2, 4, 2, 256, 100
    jp, js, payload, scales = _jax_cache(*_kv(lq + d, (2, b, kvh, w, d)))
    q = np.random.default_rng(d).standard_normal((b, h, lq, d)).astype(np.float32)
    valid = _valid(b, w, 2, off + lq)
    groups = scales.shape[-1] // 4
    for layer in range(2):
        out = TK.quantized_kv_attention(torch.from_numpy(q), payload, scales, torch.from_numpy(valid),
                                        off, layer, d**-0.5).numpy()
        ker = JK.quantized_kv_attention(
            jnp.asarray(q)[..., d_perm(d, groups)], jp, js, jnp.asarray(valid), jnp.asarray(off, jnp.int32),
            jnp.asarray(layer, jnp.int32), scale=d**-0.5, interpret=True,
        )[..., np.argsort(d_perm(d, groups))]
        np.testing.assert_allclose(out, np.asarray(ker), **KERNEL_TOL, err_msg=f"kernel, layer {layer}")
        ref = _xla(q, jp, js, layer, valid, off + np.arange(lq))
        np.testing.assert_allclose(out, ref, **F32_TOL, err_msg=f"XLA path, layer {layer}")


@pytest.mark.parametrize("d", [32, 96])
def test_quantized_flash_plain_matches_jax_kernel(d):
    """Plain K5 against the JAX kernel (interpret mode) and the JAX XLA path:
    a 40-query chunk extending a 24-position cache, over two layers."""
    b, h, kvh, w, lq, off = 1, 4, 2, 256, 40, 24
    jp, js, payload, scales = _jax_cache(*_kv(2 * d, (2, b, kvh, w, d)))
    q = np.random.default_rng(d + 1).standard_normal((b, h, lq, d)).astype(np.float32)
    valid = _valid(b, w, 4, off + lq)
    groups = scales.shape[-1] // 4
    for layer in range(2):
        out = TK.quantized_flash_attention(torch.from_numpy(q), payload, scales, torch.from_numpy(valid),
                                           off, layer, d**-0.5).numpy()
        ker = JK.quantized_flash_attention(
            jnp.asarray(q)[..., d_perm(d, groups)], jp, js, jnp.asarray(valid), jnp.asarray(off, jnp.int32),
            jnp.asarray(layer, jnp.int32), scale=d**-0.5, block_q=16, block_k=128, interpret=True,
        )[..., np.argsort(d_perm(d, groups))]
        np.testing.assert_allclose(out, np.asarray(ker), **KERNEL_TOL, err_msg=f"kernel, layer {layer}")
        ref = _xla(q, jp, js, layer, valid, off + np.arange(lq))
        np.testing.assert_allclose(out, ref, **F32_TOL, err_msg=f"XLA path, layer {layer}")


def test_plain_versions_bf16_dequantize_like_the_kernels():
    """With bf16 queries the plain versions read the cache as bf16 values
    rounded once from f32 ``q * s + b``: the same bits the CUDA kernels
    compute, and what ``read_kv`` to bf16 gives."""
    d, w = 96, 64
    _, _, payload, scales = _jax_cache(*_kv(5, (1, 1, 2, w, d)))
    q = torch.from_numpy(np.random.default_rng(5).standard_normal((1, 2, 1, d)).astype(np.float32))
    valid = torch.ones((1, w), dtype=torch.bool)
    out = TK.quantized_kv_attention(q.to(torch.bfloat16), payload, scales, valid, w - 1, 0, d**-0.5)
    k, v = TS.dequantize_kv(payload[0], scales[0], torch.bfloat16)
    ref = TK.dense_kv_attention(q.to(torch.bfloat16), k[None], v[None], valid, w - 1, 0, d**-0.5)
    assert out.dtype == torch.bfloat16 and torch.equal(out, ref)


# --- K5 on the card: K2's tensor-core flash body over tiles that
# Int4Tiles::convert dequantizes (csrc/quant_kv_attention.cu), modelled in
# plain PyTorch.  chip_smoke.py holds the kernel to its plain version there.


def test_int4_level_times_scale_is_exact_in_f32():
    """For every level q in 0..15 and every finite bf16 scale s, q * s is
    exact in f32 wherever it lies in f32's range (4 + 8 significant bits;
    a bf16 subnormal's lowest bit, 2^-133, is far above f32's): so one fused
    multiply-add, the kernels' dequantization (attention.cuh: dequant_fma),
    rounds q * s + b once, to the bits of the plain path's f32 q * s, then
    + b.  Only products past FLT_MAX (|s| > FLT_MAX / q) are not exact."""
    s = (np.arange(1 << 16, dtype=np.uint32) << 16).view(np.float32)
    s = s[np.isfinite(s)].astype(np.float64)
    assert s.size == (1 << 16) - 2 * (1 << 7)  # every bf16 but the infinities and NaNs
    prod = np.arange(16, dtype=np.float64)[:, None] * s[None, :]  # exact in float64
    with np.errstate(over="ignore"):
        f32 = prod.astype(np.float32)
    fits = np.abs(prod) <= np.finfo(np.float32).max
    assert np.array_equal(f32[fits].astype(np.float64), prod[fits])
    assert np.isinf(f32[~fits]).all()


# K2's tile-model edges (tests/test_torch_attention.py) at D = 96, three
# groups: (lq, q_pos0, lk, left pads per batch row).
K5_EDGES = {
    "batch-pads": (130, 0, 200, (0, 70)),
    "extend": (100, 1000, 1130, (12, 40)),
    "ragged": (77, 3, 145, (5, 0)),
}
# chip_smoke.py's limits for K2 and K5 (K2_ATOL + ATTN_RTOL): P rounded to
# bf16 before P V on the card, kept f32 by the plain version.
K2_LIMITS = dict(rtol=2 * 2.0**-7, atol=4e-3)


def _k5_tiles(payload, scales, lk):
    """Int4Tiles as the card fills its K and V tiles: each 64-key tile of a
    (B, KV, Lk, D) layer (keys past lk from the clamped key lk - 1), 16
    values of a key at a time from one payload chunk and its group's scale
    and bias, a level times the scale plus the bias in f32 (the product is
    exact, so fused or not the sum rounds once), rounded to bf16.  Returns
    the tiles' (k, v), each (B, KV, n_tiles * 64, D) bf16."""
    d, g = payload.shape[-1], scales.shape[-1] // 4
    ks, vs = [], []
    for j0 in range(0, lk, 64):
        rows = torch.clamp(torch.arange(j0, j0 + 64), max=lk - 1)
        chunks = payload[:, :, rows].reshape(*payload.shape[:2], 64, d // 16, 16)
        group = torch.arange(d // 16) * 16 // 32
        sc = scales[:, :, rows].float()
        plane = lambda i: sc[..., i * g + group][..., None]  # noqa: E731 - (B, KV, 64, D/16, 1)
        for lvl, s, b, out in ((chunks & 15, plane(0), plane(1), ks), (chunks >> 4, plane(2), plane(3), vs)):
            out.append((lvl.float() * s + b).to(torch.bfloat16).reshape(*payload.shape[:2], 64, d))
    return torch.cat(ks, dim=2), torch.cat(vs, dim=2)


@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("edge", list(K5_EDGES))
def test_k5_tile_model_matches_plain(edge, g):
    """K5's tiles hold dequantize_kv's bits, and K2's tile walk over them
    (64-row and 64-key tiles, P rounded to bf16) stays within K2's limits of
    quantized_flash_attention_plain: left pads, an extend at q_pos0 > 0, lq
    and lk off the tiles."""
    lq, q_pos0, lk, pads = K5_EDGES[edge]
    b, kvh, d, layer = len(pads), 2, 96, 1
    k, v = _kv(len(edge) + 10 * g, (2, b, kvh, lk, d))
    payload, scales = TS.quantize_chunk(torch.from_numpy(k), torch.from_numpy(v), KVQuantConfig(bits=4))
    q = torch.from_numpy(np.random.default_rng(g).standard_normal((b, kvh * g, lq, d)).astype(np.float32))
    q = q.to(torch.bfloat16)
    valid = torch.ones((b, lk), dtype=torch.bool)
    for bi, pad in enumerate(pads):
        valid[bi, :pad] = False
    valid[:, lk // 2] = False
    kt, vt = _k5_tiles(payload[layer], scales[layer], lk)
    kd, vd = TS.dequantize_kv(payload[layer], scales[layer], torch.bfloat16)
    assert torch.equal(kt[:, :, :lk], kd) and torch.equal(vt[:, :, :lk], vd)
    assert torch.equal(kt[:, :, lk:], kd[:, :, -1:].expand_as(kt[:, :, lk:]))  # the clamped key
    out = _k2_tile_model(q, kt[:, :, :lk], vt[:, :, :lk], valid, q_pos0, d**-0.5, round_p=True)
    ref = TK.quantized_flash_attention_plain(q, payload, scales, valid, q_pos0, layer, d**-0.5)
    np.testing.assert_allclose(out.numpy(), ref.float().numpy(), **K2_LIMITS)
    assert (out - ref.float()).abs().max() > 0  # the rounding of P is real
