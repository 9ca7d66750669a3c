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
rests on, and plain-PyTorch models of the card's K5 (its int4 tiles and K2's
tile walk over them) and K4 (its blocks of 64-key runs over the stacked
cache, and E2/E3's modes on the same kernels) held to the plain versions.
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


# --- K4 on the card: the split-run kernels (csrc/split_runs.cuh) behind the
# stacked cache's window, and E2/E3's modes on the same kernels, modelled in
# plain PyTorch.  chip_smoke.py holds the kernels to their plain versions
# there.


def _k4_split_model(q, payload, scales, valid, offset, layer, scale, block_keys, mode="fp32"):
    """K4 (mode "fp32") and E2/E3's modes as the card computes them over one
    layer of the stacked int4 cache.  The window is cut into blocks of
    ``block_keys`` keys, each walked in 64-key runs: the tiles hold the
    mode's values (Int4Run::tiles, rounded to q's type where the kernel
    rounds to bf16); a score is q * scale (rounded to q's type) dotted with
    the key tile (kMxu: per group, times the key's k scale), plus, in the
    factored modes, the query's group sums times the key's k biases; key j
    is seen from query i iff valid[b, j] and j <= offset + i (no fresh
    region); per run, the row's running max, its alpha = exp(old - new) on
    the sum and the output, and p = exp(score - max) entering P V as bf16 hi
    + lo (kMxu: p * v_scale per group); the factored modes' value biases
    summed beside the softmax sum and added to the block's output.  A
    row's merge reads its blocks up to its last visible key; a row that
    sees no key gets the uniform average of the window's values.
    kNoSoftmax: no mask, P is the score, every block is added.  Returns
    (out, live blocks per query row)."""
    from phi_3_vision_mlx_tpu_torch.ops.attention import NEG_INF

    b, h, lq, d = q.shape
    pl, sl = payload[layer], scales[layer]  # (B, KV, L, D), (B, KV, L, 4G)
    kvh, lmax, g = pl.shape[1], pl.shape[2], sl.shape[-1] // 4
    rnd = lambda t: t.to(q.dtype).float()  # noqa: E731 - the tiles' bf16 rounding, at q's type
    bf = lambda t: t.to(torch.bfloat16).float()  # noqa: E731
    dims = lambda t: t.repeat_interleave(d // g, dim=-1)  # noqa: E731 - (..., G) -> (..., D)
    heads = lambda t: t.repeat_interleave(h // kvh, dim=1)  # noqa: E731 - kv heads -> query heads
    ks, kb, vs, vb = (heads(sl[..., i * g : (i + 1) * g].float()) for i in range(4))  # (B, H, L, G)
    lk, lv = heads((pl & 15).float()), heads((pl >> 4).float())

    def tile(lvl, s, bias):
        s, bias = dims(s), dims(bias)
        return {"fp32": lambda: rnd(lvl * s + bias), "bf16": lambda: bf(bf(lvl * s) + bias),
                "nomul": lambda: rnd(lvl + s), "fbias": lambda: rnd(lvl * s)}.get(mode, lambda: lvl)()

    kt, vt = tile(lk, ks, kb), tile(lv, vs, vb)
    v_full = {"fbias": lambda: vt + dims(vb), "mxu": lambda: lv * dims(vs) + dims(vb)}.get(mode, lambda: vt)()
    factored, softmax = mode in ("fbias", "mxu"), mode != "nosoftmax"
    qs = (q * scale).float()
    qsum = qs.reshape(b, h, lq, g, d // g).sum(-1)  # (B, H, Lq, G)
    hl = lambda p: bf(p) + bf(p - bf(p))  # noqa: E731 - P as bf16 hi + lo
    n_split = -(-lmax // block_keys)
    kend = min(lmax, offset + lq) if softmax else lmax
    rows = offset + torch.arange(lq)
    parts = []
    for t in range(n_split):
        m = torch.full((b, h, lq), -torch.inf)
        l_ = torch.zeros((b, h, lq))
        acc = torch.zeros((b, h, lq, d))
        pb = torch.zeros((b, h, lq, g))
        for j0 in range(t * block_keys, min(kend, (t + 1) * block_keys), 64):
            j = torch.arange(j0, min(j0 + 64, kend, (t + 1) * block_keys))
            if mode == "mxu":
                sc = sum((qs[..., c * 32 : (c + 1) * 32] @ kt[:, :, j, c * 32 : (c + 1) * 32].transpose(-1, -2))
                         * ks[:, :, None, j, c] for c in range(g))
            else:
                sc = qs @ kt[:, :, j].transpose(-1, -2)  # (B, H, Lq, n)
            if factored:
                sc = sc + qsum @ kb[:, :, j].transpose(-1, -2)
            if softmax:
                seen = valid[:, None, None, j] & (j[None, None, None, :] <= rows[None, None, :, None])
                sc = torch.where(seen, sc, -torch.inf)
                m_new = torch.maximum(m, sc.amax(dim=-1))
                alpha = torch.where(m_new == -torch.inf, 1.0, torch.exp(m - m_new))
                p = torch.where(m_new[..., None] == -torch.inf, 0.0, torch.exp(sc - m_new[..., None]))
                l_ = l_ * alpha + p.sum(dim=-1)
                acc = acc * alpha[..., None]
                pb = pb * alpha[..., None] + p @ vb[:, :, j]
                m = m_new
            else:
                p = sc
            if mode == "mxu":
                acc = acc + torch.cat([hl(p * vs[:, :, None, j, c]) @ vt[:, :, j, c * 32 : (c + 1) * 32]
                                       for c in range(g)], dim=-1)
            else:
                acc = acc + hl(p) @ vt[:, :, j]
        if factored:
            acc = acc + dims(pb)
        parts.append((torch.where(m == -torch.inf, NEG_INF, m), l_, acc))
    if not softmax:
        return sum(acc for _, _, acc in parts), torch.full((lq,), n_split)
    out = torch.empty((b, h, lq, d))
    live = torch.tensor([min(n_split, min(lmax - 1, offset + i) // block_keys + 1) for i in range(lq)])
    for i in range(lq):
        ms = torch.stack([m[..., i] for m, _, _ in parts[: live[i]]])
        m_all = ms.amax(dim=0)
        wt = torch.exp(ms - m_all)
        o = sum(w[..., None] * acc[..., i, :] for w, (_, _, acc) in zip(wt, parts))
        o = o / sum(w * l_[..., i] for w, (_, l_, _) in zip(wt, parts))[..., None]
        out[:, :, i] = torch.where((m_all > NEG_INF)[..., None], o, v_full.mean(dim=2))
    return out, live


def _k4_case(seed, lq, lmax=320, offset=150):
    """Two batch rows over a 320-key window (five runs, the last two of 64
    keys), offset 150 mid-run: row 0 left-padded, holed, and with the key at
    the offset (the step's own, fresh) not valid; row 1 with no valid key
    (every query row sees none)."""
    d, h, kvh = 96, 4, 2
    k, v = _kv(seed, (2, 2, kvh, lmax, d))
    payload, scales = TS.quantize_chunk(torch.from_numpy(k), torch.from_numpy(v), KVQuantConfig(bits=4))
    q = torch.from_numpy(np.random.default_rng(seed).standard_normal((2, h, lq, d)).astype(np.float32))
    valid = torch.from_numpy(np.random.default_rng(seed + 1).random((2, lmax)) > 0.15)
    valid[:, :3] = False  # left padding
    valid[0, offset] = False  # a fresh key that is not valid: K4 hides it, K7's rule would not
    valid[1] = False
    return q, payload, scales, valid, offset, d**-0.5


@pytest.mark.parametrize("block_keys", [64, 128, 256, 1024])
@pytest.mark.parametrize("lq", [1, 4, 16])
def test_k4_split_model_matches_plain(lq, block_keys):
    """K4's blocks of runs (the rescale between runs), merge and P as bf16
    hi + lo equal quantized_kv_attention_plain (f32) at an offset mid-run,
    left padding, a fresh key with valid False and a row that sees no key;
    the merge reads exactly the blocks holding a key the row can see."""
    q, payload, scales, valid, offset, scale = _k4_case(lq, lq)
    out, live = _k4_split_model(q, payload, scales, valid, offset, 1, scale, block_keys)
    ref = TK.quantized_kv_attention_plain(q, payload, scales, valid, offset, 1, scale)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), **F32_TOL)
    for i in range(lq):  # every block the merge reads holds keys up to the row's own
        assert live[i] == (offset + i) // block_keys + 1
    fresh = valid.clone()
    fresh[0, offset] = True  # K7's fresh-region rule would see the key
    seen = TK.quantized_kv_attention_plain(q, payload, scales, fresh, offset, 1, scale)
    assert (seen[0] - ref[0]).abs().max() > 1e-3
    mean_v = TS.dequantize_kv(payload[1], scales[1], torch.float32)[1][1].mean(dim=1)  # (KV, D)
    np.testing.assert_allclose(ref[1].numpy(), mean_v.repeat_interleave(2, dim=0)[:, None].expand(-1, lq, -1),
                               **F32_TOL)


@pytest.mark.parametrize("block_keys", [64, 256])
@pytest.mark.parametrize("mode", TK.VARIANT_MODES)
def test_k4_mode_model_matches_variant_plain(mode, block_keys):
    """Each E2/E3 mode on K4's kernels (the mode's tiles; kMxu's per-group
    scores and p * v_scale operand; the factored biases; kNoSoftmax's raw
    scores over every block) equals quantized_kv_attention_variant_plain:
    in f32 with a softmax; with none, each of the window's score * value
    terms carries P's hi + lo rounding, at most 2^-16 of the term."""
    q, payload, scales, valid, offset, scale = _k4_case(7, 4)
    out, _ = _k4_split_model(q, payload, scales, valid, offset, 1, scale, block_keys, mode)
    ref = TK.quantized_kv_attention_variant_plain(q, payload, scales, valid, offset, 1, scale, mode)
    if mode != "nosoftmax":
        np.testing.assert_allclose(out.numpy(), ref.numpy(), **F32_TOL)
        return
    k, v = TK._variant_kv(payload[1], scales[1], mode, q.dtype)
    s = (q * scale).reshape(2, 2, 2, 4, 96) @ k[:, :, None].transpose(-1, -2)
    terms = (s.abs() @ v[:, :, None].abs()).reshape(ref.shape)
    assert ((out - ref).abs() <= F32_TOL["atol"] + 2.0**-16 * terms).all()


@pytest.mark.parametrize("lmax", [64, 200, 640, 1024, 1088, 4224, 4352])
def test_quantized_split_plan_covers_each_key_once(lmax):
    """K4's plan takes the window only; its blocks are whole runs, each
    non-empty, and each key of the window falls in exactly one."""
    import inspect

    assert list(inspect.signature(TK.quantized_split_plan).parameters) == ["lmax"]
    n_split, keys = TK.quantized_split_plan(lmax)
    assert keys % TK.RUN_KEYS == 0 and keys > 0
    covered = np.zeros(lmax, int)
    for t in range(n_split):
        lo, hi = t * keys, min((t + 1) * keys, lmax)
        assert lo < hi
        covered[lo:hi] += 1
    assert (covered == 1).all()


def test_variant_split_keys_must_be_whole_runs():
    """E3's keys per block are whole 64-key runs; another count raises."""
    q, payload, scales, valid, offset, scale = _k4_case(3, 1)
    for bad in (0, 32, 100, 1000):
        with pytest.raises(ValueError, match="multiple"):
            TK.quantized_kv_attention_variant(q, payload, scales, valid, offset, 1, scale, split_keys=bad)
    out = TK.quantized_kv_attention_variant(q, payload, scales, valid, offset, 1, scale, split_keys=1024)
    assert torch.equal(out, TK.quantized_kv_attention_plain(q, payload, scales, valid, offset, 1, scale))
