"""fp32 models over quantized weights and caches, on the CPU.

An fp32 model's activations and queries reach each kernel's fp32 entry on
the card (``_f32``), which computes the JAX package's XLA path in f32:
weights and cache entries dequantized in f32, never rounded to bf16, f32
products and sums (the TPU kernels cast the input to bf16 first, a TPU
economy the port does not copy).  Here:

* the plain fp32 versions of K1, K8, K9 (M = 1 and 8) and K4-K7 (an int4
  cache with left pads, a later row group at ``row0`` 16, page tables)
  against the JAX XLA functions (``ops/quant.py:quantized_matmul``,
  ``read_kv`` + ``masked_attention``), rtol 1e-5, atol 1e-5: f32 sums in
  another order, outputs of O(1);
* plain-PyTorch models of the card's fp32 walks held to the plain versions:
  route A's split sums and route B's 3xTF32 k-steps over f32 weights
  (``csrc/quant_matmul.cu``: ``wq_tf32_kernel``), the split-run body in
  3xTF32 (``csrc/split_runs.cuh``: ``split_run_tf32_kernel``, K4, K6, K7)
  and K5's 3xTF32 tile walk over f32-dequantized int4 tiles;
* the wrappers' dispatch with the library stubbed: an f32 input calls the
  ``_f32`` entry, bf16 the bf16 one, a mix raises, a failed launch raises;
* the slice: the tiny fp32 model with 4-bit weights over the int4 cache,
  ``api.generate`` and both batching engines against the JAX package.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_attention import _k2_tile_model, _mm_3xtf32_steps  # noqa: E402
from test_torch_kv_quant import _jax_cache, _k4_split_model, _kv, _xla  # noqa: E402
from test_torch_model import ReplayJaxCache, make_checkpoint, one_thread  # noqa: E402,F401
from test_torch_paged import _case, _paged_split_model  # noqa: E402

from phi_3_vision_mlx_tpu.api import _load as jax_load  # noqa: E402
from phi_3_vision_mlx_tpu.core.config import KVQuantConfig  # noqa: E402
from phi_3_vision_mlx_tpu.engine import state as JS  # noqa: E402
from phi_3_vision_mlx_tpu.engine.batching import BatchEngine as JBatch  # noqa: E402
from phi_3_vision_mlx_tpu.engine.paging import PagedBatchEngine as JPaged  # noqa: E402
from phi_3_vision_mlx_tpu.ops import quant as JQ  # noqa: E402
from phi_3_vision_mlx_tpu.ops.attention import masked_attention as jax_masked_attention  # noqa: E402
from phi_3_vision_mlx_tpu_torch import api as TA  # noqa: E402
from phi_3_vision_mlx_tpu_torch.core.convert import from_jax_paged_pool, from_numpy_params  # noqa: E402
from phi_3_vision_mlx_tpu_torch.core.weights import pack_int4, pack_int8, to_packed_layout  # noqa: E402
from phi_3_vision_mlx_tpu_torch.engine import state as TS  # noqa: E402
from phi_3_vision_mlx_tpu_torch.engine.batching import BatchEngine as TBatch  # noqa: E402
from phi_3_vision_mlx_tpu_torch.engine.engine import LM  # noqa: E402
from phi_3_vision_mlx_tpu_torch.engine.paging import PagedBatchEngine as TPaged  # noqa: E402
from phi_3_vision_mlx_tpu_torch.models import phi3 as TM  # noqa: E402
from phi_3_vision_mlx_tpu_torch.models.preprocess import Phi3Processor  # noqa: E402
from phi_3_vision_mlx_tpu_torch.ops.kernels import _build  # noqa: E402
from phi_3_vision_mlx_tpu_torch.ops.kernels import kv_attention as TK  # noqa: E402
from phi_3_vision_mlx_tpu_torch.ops.kernels import quant_matmul as QM  # noqa: E402
from phi_3_vision_mlx_tpu_torch.ops.quant import QTensor, dequantize  # noqa: E402

# f32 against f32: the same values summed in another order, outputs of O(1).
F32 = dict(rtol=1e-5, atol=1e-5)
K, N, GROUP = 1024, 1536, 64  # N: three 512-column blocks of the packed layout


def _planes(rng, k, n, step=0.004):
    """bf16 scales and biases (the port keeps them in bf16), as f32 arrays."""
    s = torch.from_numpy(step * (1 + 0.1 * rng.standard_normal((k // GROUP, n)))).to(torch.bfloat16)
    b = torch.from_numpy(-0.03 + 0.001 * rng.standard_normal((k // GROUP, n))).to(torch.bfloat16)
    return s, b


def _matmul_case(layout, seed, m, symmetric=False):
    """(x f32, the port's payload, scales, biases, levels) of ``layout``."""
    rng = np.random.default_rng(seed)
    bits = 8 if layout == "k8" else 4
    q = torch.from_numpy(rng.integers(0, 1 << bits, (K, N)).astype(np.uint8))
    s, b = _planes(rng, K, N, 0.004 * 15 / ((1 << bits) - 1))
    payload = {"k1": pack_int4, "k8": pack_int8, "k9": to_packed_layout}[layout](q)
    x = torch.from_numpy(rng.standard_normal((m, K)).astype(np.float32))
    return x, payload, s, None if symmetric else b, q


PLAIN = {"k1": QM.quant_matmul, "k8": QM.quant_matmul_w8, "k9": QM.quant_matmul_packed}

# --- the plain fp32 versions against the JAX XLA functions -------------------


@pytest.mark.parametrize("m", [1, 8])
@pytest.mark.parametrize("layout,symmetric", [("k1", False), ("k1", True), ("k8", False), ("k9", False)])
def test_fp32_quantized_matmul_plain_matches_jax_xla(layout, symmetric, m):
    """K1 (affine and symmetric), K8 and K9 on an f32 x: the wrapper (the
    plain version on the CPU) against ``ops/quant.py:quantized_matmul``
    at HIGHEST precision, rtol 1e-5 / atol 1e-5."""
    x, payload, s, b, q = _matmul_case(layout, m + 10 * len(layout), m, symmetric)
    out = PLAIN[layout](x, payload, s, b)
    assert out.dtype == torch.float32 and out.shape == (m, N)
    jt = JQ.QTensor(jnp.asarray(q.numpy()), jnp.asarray(s.float().numpy()),
                    None if b is None else jnp.asarray(b.float().numpy()))
    want = np.asarray(JQ.quantized_matmul(jnp.asarray(x.numpy()), jt, dtype=jnp.float32))
    np.testing.assert_allclose(out.numpy(), want, **F32)


def _int4_stack(seed, b, kvh, lmax, d=96):
    """(JAX payload, JAX scales, the port's payload, scales), two layers."""
    return _jax_cache(*_kv(seed, (2, b, kvh, lmax, d)))


@pytest.mark.parametrize("lq,row0", [(1, 0), (8, 0), (16, 16)])
def test_fp32_k4_plain_matches_jax_xla(lq, row0):
    """K4's plain version on an f32 query over the int4 cache (two rows,
    left pads of 3 and 20, a later row group at row0 16) against the JAX
    XLA path: ``read_kv`` in f32, then ``masked_attention``."""
    b, h, kvh, lmax, d, offset = 2, 4, 2, 160, 96, 100
    jp, js, payload, scales = _int4_stack(lq + row0, b, kvh, lmax)
    rng = np.random.default_rng(lq)
    q = rng.standard_normal((b, h, lq, d)).astype(np.float32)
    valid = np.ones((b, lmax), bool)
    valid[0, :3], valid[1, :20] = False, False
    out = TK.quantized_kv_attention(torch.from_numpy(q), payload, scales, torch.from_numpy(valid), offset, 1,
                                    d**-0.5, row0=row0)
    assert out.dtype == torch.float32
    want = _xla(q, jp, js, 1, valid, offset + row0 + np.arange(lq))
    np.testing.assert_allclose(out.numpy(), want, **F32)


@pytest.mark.parametrize("lq,q_pos0", [(40, 0), (24, 100)])
def test_fp32_k5_plain_matches_jax_xla(lq, q_pos0):
    """K5's plain version on an f32 prefill (left pads 3 and 20) and an
    extend chunk over the int4 cache against the JAX XLA path."""
    b, h, kvh, d = 2, 4, 2, 96
    lmax = q_pos0 + lq
    jp, js, payload, scales = _int4_stack(lq, b, kvh, lmax)
    q = np.random.default_rng(lq).standard_normal((b, h, lq, d)).astype(np.float32)
    valid = np.ones((b, lmax), bool)
    valid[0, :3], valid[1, :20] = False, False
    out = TK.quantized_flash_attention(torch.from_numpy(q), payload, scales, torch.from_numpy(valid), q_pos0, 1,
                                       d**-0.5)
    want = _xla(q, jp, js, 1, valid, q_pos0 + np.arange(lq))
    np.testing.assert_allclose(out.numpy(), want, **F32)


def _paged_xla(q, k_pool, v_pool, tables, valid, offsets, row0):
    """The JAX XLA path through page tables: each slot's window gathered
    from the (pages, KV, page, D) pool plus the zero spare page, then
    ``masked_attention`` under the fresh-region rule."""
    pages, kvh, page, d = k_pool.shape
    spare = np.zeros((1, kvh, page, d), np.float32)
    kp, vp = np.concatenate([k_pool, spare]), np.concatenate([v_pool, spare])
    win = lambda p: p[tables].transpose(0, 2, 1, 3, 4).reshape(len(tables), kvh, -1, d)  # noqa: E731
    w = tables.shape[1] * page
    key = np.arange(w)[None, None, :]
    off = offsets[:, None, None]
    pos = off + row0 + np.arange(q.shape[2])[None, :, None]
    allowed = (((key < off) & valid[:, None, :]) | ((key >= off) & (key <= pos)))[:, None]
    return np.asarray(jax_masked_attention(jnp.asarray(q), jnp.asarray(win(kp)), jnp.asarray(win(vp)),
                                           jnp.asarray(allowed), q.shape[-1] ** -0.5))


@pytest.mark.parametrize("lq,row0", [(1, 0), (4, 0), (16, 16)])
def test_fp32_k6_k7_plain_match_jax_xla(lq, row0):
    """K6 over an f32 pool and K7 over the int4 pool, f32 queries through
    page tables (ragged offsets, sentinel tails, a left-padded and holed
    validity row), against the JAX XLA path's gather and masked attention."""
    q, k, v, tables, valid, offsets = _case("D96-page64", lq + row0, seed=lq)
    q = q[:, :, :lq]
    scale = q.shape[-1] ** -0.5
    pk, pv = from_jax_paged_pool(k, v, dtype=torch.float32)
    args = (torch.from_numpy(tables), torch.from_numpy(valid), torch.from_numpy(offsets), 0, scale)
    got = TK.paged_kv_attention(torch.from_numpy(q), pk[None], pv[None], *args, row0=row0)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _paged_xla(q, k, v, tables, valid, offsets, row0), **F32)
    e = JS.quantize_chunk(jnp.asarray(k), jnp.asarray(v), KVQuantConfig(bits=4), True)
    payload, scales = from_jax_paged_pool(np.asarray(e.k), np.asarray(e.k_scales.astype(jnp.float32)),
                                          quantized=True)
    kd, vd = (np.asarray(t) for t in JS.read_kv(JS.LayerKV(k=e.k, k_scales=e.k_scales), jnp.float32, 4))
    got = TK.paged_quantized_kv_attention(torch.from_numpy(q), payload[None], scales[None], *args, row0=row0)
    np.testing.assert_allclose(got.numpy(), _paged_xla(q, kd, vd, tables, valid, offsets, row0), **F32)


# --- models of the card's fp32 walks, held to the plain versions ------------


def _f32_weights(layout, payload, s, b):
    """W as the fp32 kernels dequantize it: s * q + b in f32 (the FMA is
    exact: q * s has at most 8 + 8 significant bits), never rounded."""
    unpack = {"k1": QM.unpack_int4, "k8": QM.unpack_int8, "k9": QM.packed_unpack(payload, s)}[layout]
    return dequantize(QTensor(unpack(payload), s, b), dtype=torch.float32)


def _route_a_f32_model(x, w, layout):
    """Route A in fp32 (``k1_gemv_kernel`` with f32 x): the plan's splits,
    each split's groups dealt to four warps in turn (g0 + w, g0 + w + 4,
    ...), each warp's f32 sum over its groups, the warps added in order,
    then the splits in order (``sum_splits``)."""
    m, k = x.shape
    assert m == 1 and QM.route(m, layout) == "a"
    splits, per = QM.plan(m, k, w.shape[1], layout)
    total = torch.zeros((m, w.shape[1]))
    for sp in range(splits):
        g0, g1 = sp * per, min(k // GROUP, (sp + 1) * per)
        acc = torch.zeros((m, w.shape[1]))
        for warp in range(4):
            part = torch.zeros((m, w.shape[1]))
            for g in range(g0 + warp, g1, 4):
                rows = slice(g * GROUP, (g + 1) * GROUP)
                part = part + x[:, rows] @ w[rows]
            acc = acc + part
        total = total + acc
    return total


def _route_b_f32_tiles(layout, payload, s, b, tile, g):
    """The f32 weights ``wq_tf32_kernel``'s B fragments hold for group ``g``
    of column tile ``tile`` (the loader's ``frag_f32`` over its staged
    bytes), as (64, 128) f32, and the output column of each of the tile's
    128 columns.  WordTiles: word row r of the group holds rows kPer r + e
    (4 bits: nibble e; 8 bits: byte e), tile column c is column tile * 128 +
    c.  PackedTiles: staged row i is packed row (g / gk) block_k + i gk + g %
    gk, byte j's low nibble tile column j, its high nibble 64 + j."""
    n = s.shape[1]
    if layout == "k9":
        lo0 = (tile // 4) * 512 + (tile % 4) * 64
        cols = torch.cat([lo0 + torch.arange(64), lo0 + 256 + torch.arange(64)])
        bk = min(512, payload.shape[0])
        gk = bk // GROUP
        rows = (g // gk) * bk + torch.arange(64) * gk + g % gk
        byte = payload[rows][:, (tile // 4) * 256 + (tile % 4) * 64 + torch.arange(64)].long()
        lv = torch.cat([byte & 15, byte >> 4], dim=1).float()
    else:
        bits = 4 if layout == "k1" else 8
        per = 32 // bits
        cols = tile * 128 + torch.arange(128)
        live = cols < n
        words = torch.zeros((2 * bits, 128), dtype=torch.int64)
        words[:, live] = payload[g * 2 * bits:(g + 1) * 2 * bits, cols[live]].long() & 0xFFFFFFFF
        lv = torch.stack([(words >> (bits * e)) & ((1 << bits) - 1) for e in range(per)], 1)
        lv = lv.reshape(64, 128).float()
    live = cols < n
    sc = torch.where(live, s[g, cols.clamp(max=n - 1)].float(), 0.0)
    if b is None:
        w = (lv - 8) * sc
    else:
        w = lv * sc + torch.where(live, b[g, cols.clamp(max=n - 1)].float(), 0.0)
    return w, cols


# Route B's k-steps in fp32: k slots t and t + 4 of k-step s stand for rows
# 16 t + 2 s and + 1 of the group (the rows thread t's payload words carry).
ROUTE_B_STEPS = [torch.tensor([16 * t + 2 * s + w for t in range(4) for w in range(2)]) for s in range(8)]


def _route_b_f32_model(x, layout, payload, s, b, w_ref):
    """Route B in fp32 (``wq_tf32_kernel``): per 128-column tile and split of
    the plan, each group's f32 weights (bit for bit ``w_ref``'s, the plain
    dequantization, before any split) in the fragments' eight k-steps, each
    k-step's product in 3xTF32 (x and W split into tf32 hi + lo, lo * lo
    dropped), the group's k-steps summed from zero and added to the tile's
    sum, the splits added in order."""
    m, k = x.shape
    n = s.shape[1]
    assert QM.route(m, layout) == "b"
    splits, per = QM.plan(m, k, n, layout)
    out = torch.zeros((splits, m, n))
    for tile in range(-(-n // 128)):
        for sp in range(splits):
            acc = torch.zeros((m, 128))
            for g in range(sp * per, min(k // GROUP, (sp + 1) * per)):
                w, cols = _route_b_f32_tiles(layout, payload, s, b, tile, g)
                live = cols < n
                assert torch.equal(w[:, live], w_ref[g * GROUP:(g + 1) * GROUP, cols[live]])
                acc = acc + _mm_3xtf32_steps(x[:, g * GROUP:(g + 1) * GROUP], w, ROUTE_B_STEPS)
            live = cols < n
            out[sp][:, cols[live]] = acc[:, live]
    total = torch.zeros((m, n))
    for sp in range(splits):
        total = total + out[sp]
    return total


@pytest.mark.parametrize("layout,symmetric", [("k1", False), ("k1", True), ("k8", False)])
def test_fp32_route_a_model_matches_plain(layout, symmetric):
    """Route A in fp32 at one row equals the plain fp32 version (only the
    order of the f32 sums differs)."""
    x, payload, s, b, _ = _matmul_case(layout, 3, 1, symmetric)
    w = _f32_weights(layout, payload, s, b)
    out = _route_a_f32_model(x, w, layout)
    np.testing.assert_allclose(out.numpy(), PLAIN[layout](x, payload, s, b).numpy(), **F32)


@pytest.mark.parametrize("m", [2, 17])
@pytest.mark.parametrize("layout,symmetric", [("k1", False), ("k1", True), ("k8", False), ("k9", False)])
def test_fp32_route_b_model_matches_plain(layout, symmetric, m):
    """Route B in fp32 (K9 at every M): the weights the loaders' fragments
    hold equal the plain version's f32 W bit for bit at every staged column,
    the ragged N edge included (K1 and K8 at N = 1160), and the 3xTF32 sums
    equal it."""
    x, payload, s, b, _ = _matmul_case(layout, 7 + m, m, symmetric)
    if layout != "k9":  # a ragged last tile: 1160 = 9 x 128 + 8
        payload, s = payload[:, :1160].contiguous(), s[:, :1160].contiguous()
        b = None if b is None else b[:, :1160].contiguous()
    w_ref = _f32_weights(layout, payload, s, b)
    out = _route_b_f32_model(x, layout, payload, s, b, w_ref)
    np.testing.assert_allclose(out.numpy(), PLAIN[layout](x, payload, s, b).numpy(), **F32)


def test_fp32_route_b_model_at_one_row():
    """K9 in fp32 takes route B at one row too: a 16-row tile holding one
    row of x, the 3xTF32 sums equal the plain version."""
    x, payload, s, b, _ = _matmul_case("k9", 29, 1)
    out = _route_b_f32_model(x, "k9", payload, s, b, _f32_weights("k9", payload, s, b))
    np.testing.assert_allclose(out.numpy(), QM.quant_matmul_packed(x, payload, s, b).numpy(), **F32)


@pytest.mark.parametrize("block_keys", [64, 256])
@pytest.mark.parametrize("lq,row0", [(1, 0), (8, 0), (16, 16)])
def test_fp32_k4_split_model_matches_plain(lq, row0, block_keys):
    """The split-run body in fp32 (both products in 3xTF32, P split into
    tf32 hi + lo, the rescale between runs, the fixed-order merge) over the
    int4 stacked cache equals K4's plain fp32 version; a row with no valid
    key takes the uniform average."""
    b, h, kvh, lmax, d, offset = 2, 4, 2, 320, 96, 150
    _, _, payload, scales = _int4_stack(lq, b, kvh, lmax)
    q = torch.from_numpy(np.random.default_rng(lq).standard_normal((b, h, lq, d)).astype(np.float32))
    valid = torch.from_numpy(np.random.default_rng(lq + 1).random((b, lmax)) > 0.15)
    valid[:, :3] = False
    valid[1] = False
    out, _ = _k4_split_model(q, payload, scales, valid, offset, 1, d**-0.5, block_keys, row0=row0,
                             f32_body=True)
    ref = TK.quantized_kv_attention_plain(q, payload, scales, valid, offset, 1, d**-0.5, row0=row0)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), **F32)


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("lq,row0", [(1, 0), (16, 16)])
def test_fp32_k6_k7_split_model_matches_plain(lq, row0, quantized):
    """The fp32 split-run body through page tables: K6 over an f32 pool,
    K7 over the int4 pool dequantized in f32 (``Int4RunF32``'s values), each
    in its loader's k order, runs merged up to each row's last visible key,
    against the plain versions."""
    q, k, v, tables, valid, offsets = _case("D96-page64", lq + row0, seed=5)
    q = torch.from_numpy(q[:, :, :lq])
    args = (torch.from_numpy(tables), torch.from_numpy(valid), torch.from_numpy(offsets))
    scale = q.shape[-1] ** -0.5
    if quantized:
        payload, scales = TS.quantize_chunk(torch.from_numpy(k), torch.from_numpy(v), KVQuantConfig(bits=4))
        pool = [torch.cat([t, torch.zeros_like(t[:1])]) for t in (payload, scales)]  # the spare page
        kd, vd = TS.dequantize_kv(*pool, torch.float32)
        ref = TK.paged_quantized_kv_attention_plain(q, pool[0][None], pool[1][None], *args, 0, scale, row0)
    else:
        kd, vd = from_jax_paged_pool(k, v, dtype=torch.float32)
        ref = TK.paged_kv_attention_plain(q, kd[None], vd[None], *args, 0, scale, row0)
    out, _ = _paged_split_model(q, kd, vd, *args, scale, row0, f32_body="int4" if quantized else "dense")
    np.testing.assert_allclose(out.numpy(), ref.numpy(), **F32)


@pytest.mark.parametrize("quantized", [False, True])
def test_fp32_k6_k7_split_model_clamps_table_entries(quantized):
    """Table entries outside [0, P] (past the spare page, negative) read the
    page the kernels clamp them to: the fp32 body's model over the bad table
    equals the plain versions over the clamped one."""
    q, k, v, tables, valid, offsets = _case("D96-page64", 8, seed=11)
    q = torch.from_numpy(q)
    pages = k.shape[0] + 1  # the pool and its spare page
    bad = tables.copy()
    bad[0, 0], bad[1, 1], bad[2, 0] = pages + 5, -3, -1
    good = np.clip(bad, 0, pages - 1)
    scale = q.shape[-1] ** -0.5
    args = (torch.from_numpy(valid), torch.from_numpy(offsets))
    if quantized:
        payload, scales = TS.quantize_chunk(torch.from_numpy(k), torch.from_numpy(v), KVQuantConfig(bits=4))
        pool = [torch.cat([t, torch.zeros_like(t[:1])]) for t in (payload, scales)]
        kd, vd = TS.dequantize_kv(*pool, torch.float32)
        ref = TK.paged_quantized_kv_attention_plain(q, pool[0][None], pool[1][None], torch.from_numpy(good), *args,
                                                    0, scale)
    else:
        kd, vd = from_jax_paged_pool(k, v, dtype=torch.float32)
        ref = TK.paged_kv_attention_plain(q, kd[None], vd[None], torch.from_numpy(good), *args, 0, scale)
    out, _ = _paged_split_model(q, kd, vd, torch.from_numpy(bad), *args, scale, f32_body="int4" if quantized else "dense")
    np.testing.assert_allclose(out.numpy(), ref.numpy(), **F32)


@pytest.mark.parametrize("lq,q_pos0,pads", [(64, 0, (14,)), (45, 3, (5, 30)), (33, 0, (77,))])
def test_fp32_k5_tile_walk_matches_plain(lq, q_pos0, pads):
    """K5 in fp32: ``Int4F32Tiles`` fills f32 tiles with ``dequantize_kv``'s
    f32 values (one FMA of q * s + b is exact there), and fp32 K2's 3xTF32
    walk over them (64-row blocks, 64-key tiles) equals K5's plain fp32
    version; a row with no valid key takes the uniform average."""
    b, kvh, d = len(pads), 2, 96
    lk = q_pos0 + lq + 13  # keys past the chunk, unwritten and masked
    k, v = _kv(lq, (2, b, kvh, lk, d))
    payload, scales = TS.quantize_chunk(torch.from_numpy(k), torch.from_numpy(v), KVQuantConfig(bits=4))
    q = torch.from_numpy(np.random.default_rng(lq).standard_normal((b, 2 * kvh, lq, d)).astype(np.float32))
    valid = torch.ones((b, lk), dtype=torch.bool)
    for i, pad in enumerate(pads):
        valid[i, :pad] = False
    kd, vd = TS.dequantize_kv(payload[1], scales[1], torch.float32)
    lv, s_, b_ = (payload[1] & 15).float(), scales[1][..., :3].float(), scales[1][..., 3:6].float()
    assert torch.equal(kd, (lv.reshape(b, kvh, lk, 3, 32) * s_[..., None] + b_[..., None]).reshape(kd.shape))
    out = _k2_tile_model(q, kd, vd, valid, q_pos0, d**-0.5, round_p=False, tile=64, tf32x3=True)
    ref = TK.quantized_flash_attention_plain(q, payload, scales, valid, q_pos0, 1, d**-0.5)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), **F32)


# --- dispatch, with the library stubbed (no card here) -----------------------


class _StubLib:
    """Records the C entry each launch calls; returns ``err``."""

    def __init__(self, err=0):
        self.calls, self.err = [], err

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append(name)
            return self.err

        return entry


@pytest.fixture
def stub(monkeypatch):
    lib = _StubLib()
    monkeypatch.setattr(_build, "library", lambda: (lib, 0.0))
    monkeypatch.setattr(_build, "stream_ptr", lambda device: 0)
    return lib


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def _launches(wrapper):
    return wrapper.launches, wrapper.fp32.launches


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dispatch_calls_the_entry_of_the_input_type(stub, dtype):
    """Every wrapper's launch calls its ``_f32`` entry for f32 inputs and
    its bf16 entry for bf16 ones, and counts the launch on the wrapper and,
    for f32, on ``wrapper.fp32``."""
    f32 = dtype == torch.float32
    suffix = "_f32" if f32 else ""
    w4, s = _meta((K // 8, N), torch.int32), _meta((K // GROUP, N), torch.bfloat16)
    for wrapper, entry, layout, payload, extra in (
            (QM.quant_matmul, "k1_w4a16_matmul", "k1", w4, ()),
            (QM.quant_matmul_w8, "k8_w8a16_matmul", "k8", _meta((K // 4, N), torch.int32), ()),
            (QM.quant_matmul_packed, "k9_w4a16_packed_matmul", "k9", _meta((K, N // 2), torch.uint8), (512,))):
        for m in (1, 8):
            before = _launches(wrapper)
            out = QM._launch(wrapper, entry, layout, _meta((m, K), dtype), payload, s, s, torch.float32, N,
                             *extra)
            assert stub.calls[-1] == entry + suffix and out.dtype == torch.float32
            assert _launches(wrapper) == (before[0] + 1, before[1] + f32)
    q = _meta((1, 4, 8, 96), dtype)
    payload, scales = _meta((2, 1, 2, 128, 96), torch.uint8), _meta((2, 1, 2, 128, 12), torch.bfloat16)
    valid, off = _meta((1, 128), torch.bool), _meta((1,), torch.int32)
    before = _launches(TK.quantized_kv_attention)
    TK._quantized_decode_launch("k4_quantized_kv_attention", q, payload, scales, valid, off, 1, 0.1, 64)
    assert stub.calls[-1] == "k4_quantized_kv_attention" + suffix
    out = TK._flash_launch(q, payload, scales, valid, 0, 1, 0.1)
    assert stub.calls[-1] == "k5_quantized_flash_attention" + suffix and out.dtype == dtype
    assert _launches(TK.quantized_flash_attention)[1] >= int(f32)
    tables, offsets = _meta((1, 2), torch.int32), _meta((1,), torch.int32)
    pool = _meta((2, 3, 2, 64, 96), dtype)
    for entry in ("k6_paged_kv_attention", "k7_paged_quantized_kv_attention"):
        out = TK._paged_launch(entry, q, pool, pool, tables, valid, offsets, 1, 0.1, 2, 64, 0)
        assert stub.calls[-1] == entry + suffix and out.dtype == dtype
    assert before[0] <= TK.quantized_kv_attention.launches


def test_dispatch_refuses_a_mix_of_types():
    """bf16 x with an f32 output is taken, f32 x with a bf16 output is not
    (no kernel rounds an fp32 model's output), nor an f16 x; K4/K5 take bf16
    or f32 queries, K6 a pool of its query's type."""
    w4, s = _meta((K // 8, N), torch.int32), _meta((K // GROUP, N), torch.bfloat16)
    check = lambda x, out: QM.check_kernel_inputs("k1", x, w4, torch.int32, s, s, out, N)  # noqa: E731
    check(_meta((1, K), torch.float32), torch.float32)
    check(_meta((1, K), torch.bfloat16), torch.float32)
    check(_meta((1, K), torch.bfloat16), torch.bfloat16)
    for x, out in ((torch.float32, torch.bfloat16), (torch.float16, torch.float16)):
        with pytest.raises(TypeError, match="bf16 x with bf16/f32 output or f32 x with f32 output"):
            check(_meta((1, K), x), out)
    payload, scales = _meta((2, 1, 2, 128, 96), torch.uint8), _meta((2, 1, 2, 128, 12), torch.bfloat16)
    valid = _meta((1, 128), torch.bool)
    for dtype in (torch.float32, torch.bfloat16):
        TK.check_quantized_inputs(_meta((1, 4, 1, 96), dtype), payload, scales, valid, 1, "k4")
    with pytest.raises(TypeError, match="bf16 or fp32 q"):
        TK.check_quantized_inputs(_meta((1, 4, 1, 96), torch.float16), payload, scales, valid, 1, "k4")
    q32, pool16 = _meta((1, 4, 1, 96), torch.float32), _meta((2, 3, 2, 64, 96), torch.bfloat16)
    TK.check_pool_dtype(q32, pool16.float(), pool16.float())
    with pytest.raises(TypeError, match="a pool of q's type"):
        TK.check_pool_dtype(q32, pool16, pool16)


def test_a_failed_fp32_launch_raises(monkeypatch):
    """An fp32 launch whose entry returns an error raises, counts nothing and
    runs no plain version instead."""
    lib = _StubLib(err=1)
    monkeypatch.setattr(_build, "library", lambda: (lib, 0.0))
    monkeypatch.setattr(_build, "stream_ptr", lambda device: 0)
    monkeypatch.setattr(QM, "quant_matmul_plain", lambda *a, **k: pytest.fail("fell back to the plain version"))
    before = _launches(QM.quant_matmul)
    w4, s = _meta((K // 8, N), torch.int32), _meta((K // GROUP, N), torch.bfloat16)
    with pytest.raises(RuntimeError, match="k1_w4a16_matmul_f32: CUDA error 1"):
        QM._launch(QM.quant_matmul, "k1_w4a16_matmul", "k1", _meta((1, K), torch.float32), w4, s, s,
                   torch.float32, N)
    assert _launches(QM.quant_matmul) == before and lib.calls == ["k1_w4a16_matmul_f32"]


def test_every_fp32_entry_has_its_bf16_entrys_signature():
    """The library's fp32 entries take their bf16 entries' arguments."""
    for name in ("k1_w4a16_matmul", "k8_w8a16_matmul", "k9_w4a16_packed_matmul", "k2_flash_attention",
                 "k3_dense_kv_attention", "k4_quantized_kv_attention", "k5_quantized_flash_attention",
                 "k6_paged_kv_attention", "k7_paged_quantized_kv_attention"):
        assert _build.SIGNATURES[name + "_f32"] == _build.SIGNATURES[name]


# --- the slice: the tiny fp32 model, 4-bit weights, the int4 cache ----------


@pytest.fixture(scope="module")
def int4_pair(tmp_path_factory):
    """(JAX (lm, proc), port (lm, proc)): the tiny fp32 checkpoint with 4-bit
    weights, both over the int4 cache; the port's weights come from the
    JAX tree (``from_numpy_params``)."""
    path = make_checkpoint(tmp_path_factory.mktemp("ckpt"), "tiny")
    jlm, jproc = jax_load(path, use_quantized_cache=True)
    assert jlm.cfg.dtype == "float32" and jlm.cfg.quantized.bits == 4 and jlm.cfg.use_quantized_cache
    tree = jax.tree_util.tree_map(np.asarray, jlm.params)
    tlm = LM(jlm.cfg, from_numpy_params(tree, jlm.cfg), device="cpu")
    return (jlm, jproc), (tlm, Phi3Processor(path))


PROMPT = "Tell me about the keeper of the lighthouse."


def test_fp32_int4_generate_matches_jax(int4_pair, monkeypatch):
    """``api.generate`` (16 greedy tokens) gives the JAX package's text, the
    port's cache writes replaced by the JAX run's entries where its own
    differ (``ReplayJaxCache``: at most one level, at most 1e-3 of them)."""
    from phi_3_vision_mlx_tpu import api as JA
    from phi_3_vision_mlx_tpu.engine import engine as JE
    from phi_3_vision_mlx_tpu.models import phi3 as JM

    (jlm, jproc), (tlm, tproc) = int4_pair
    kw = dict(max_tokens=16, verbose=False, stream=False, mute=True)
    want = JA.generate(PROMPT, preload=(jlm, jproc), **kw)
    dict_input = jproc(TA._apply_chat_template(PROMPT)[0])
    jl, state, _, _ = JE.run_prefill(jlm, dict_input, 16)
    tok = np.asarray(jl).argmax(-1)[:, None]
    for _ in range(15):
        res = JM.decode_forward(jlm.params, jlm.cfg, state, jnp.asarray(tok))
        state, tok = res.state, np.asarray(res.logits[:, -1]).argmax(-1)[:, None]
    replay = ReplayJaxCache(state, 4)
    monkeypatch.setattr(TM, "update_layer_chunk", replay)
    got = TA.generate(PROMPT, preload=(tlm, tproc), **kw)
    assert got == want and got[0]
    replay.check()


def _engine_tokens(eng, prompts, n):
    rids = [eng.submit(p, max_tokens=n) for p in prompts]
    while eng.pending():
        eng.step(4)
    return [eng.tokens(r) for r in rids]


@pytest.mark.parametrize("paged", [False, True], ids=["slots", "pages"])
def test_fp32_int4_engines_match_jax(int4_pair, paged):
    """The slot and the paged engine with 2 slots over the int4 cache give
    each of two requests the JAX engine's tokens."""
    (jlm, jproc), (tlm, tproc) = int4_pair
    prompts = [PROMPT, "Write two lines about the tide."]
    kw = dict(slots=2, window=256, **({"page_size": 64} if paged else {}))
    want = _engine_tokens((JPaged if paged else JBatch)(jlm, jproc, **kw), prompts, 12)
    got = _engine_tokens((TPaged if paged else TBatch)(tlm, tproc, **kw), prompts, 12)
    assert got == want and all(len(t) == 12 for t in got)
