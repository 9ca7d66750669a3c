"""Plain versions of kernels K2 (flash attention) and K3 (decode attention
over the stacked cache) against the JAX package's ``masked_attention``.

``flash_attention`` and ``dense_kv_attention`` of the JAX package take no
``interpret`` argument, so the JAX side is the function those kernels stand
in for on the CPU: ``ops/attention.py:masked_attention`` with the same
derived mask (causal from the query positions, left padding and ``valid``
bits).  Inputs come from ``np.random.default_rng`` and go to both packages.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from phi_3_vision_mlx_tpu.ops import attention as JA  # noqa: E402
from phi_3_vision_mlx_tpu_torch.ops import attention as TA  # noqa: E402
from phi_3_vision_mlx_tpu_torch.ops.kernels import flash_attention as K2  # noqa: E402
from phi_3_vision_mlx_tpu_torch.ops.kernels import kv_attention as K3  # noqa: E402
from test_torch_model import one_thread  # noqa: E402,F401  (autouse: one torch thread)

D = 32
SCALE = D**-0.5
# f32 on both sides; only the order of the f32 sums differs.  Outputs are
# O(1) weighted averages of N(0, 1) values; each score is a 32-term f32 dot
# product and each softmax runs over at most 96 keys, so the accumulated
# rounding is a few e-6, more where XLA's CPU threading reorders the sums (a
# tier-1 run once saw 4.5e-5 against the float64 answer).  1e-4 absolute
# covers that; test_f32_tolerance_catches_a_dropped_key shows that a real
# fault still moves the output by far more.
F32_TOL = dict(rtol=0, atol=1e-4)


def _mask(valid, q_pos, lk):
    key_pos = np.arange(lk)
    return (key_pos[None, :] <= q_pos[:, None])[None, None] & valid[:, None, None, :]


def _inputs(seed, b, h, kvh, lq, lk, pad):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, lq, D)).astype(np.float32)
    k = rng.standard_normal((b, kvh, lk, D)).astype(np.float32)
    v = rng.standard_normal((b, kvh, lk, D)).astype(np.float32)
    valid = np.ones((b, lk), bool)
    valid[:, :pad] = False  # left padding
    valid[:, pad + 3] = False  # an attention-dropped position
    return q, k, v, valid


def _jax(q, k, v, allowed):
    return np.asarray(JA.masked_attention(*map(jnp.asarray, (q, k, v, allowed)), SCALE))


def _float64(q, k, v, allowed):
    """The same masked attention in float64 numpy (finite NEG_INF included)."""
    g = q.shape[1] // k.shape[1]
    k, v = (np.repeat(a.astype(np.float64), g, axis=1) for a in (k, v))
    s = np.einsum("bhqd,bhld->bhql", q.astype(np.float64) * SCALE, k)
    s = np.where(allowed, s, JA.NEG_INF)
    p = np.exp(s - s.max(axis=-1, keepdims=True))
    return np.einsum("bhql,bhld->bhqd", p / p.sum(axis=-1, keepdims=True), v)


@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("q_pos0", [0, 40])
def test_flash_plain_matches_jax(g, q_pos0):
    """Prefill (q_pos0 = 0) and extend (a chunk at offset 40) over a window.
    Each side is also held to the float64 answer, so a mismatch names the
    side that is off."""
    b, kvh, lq, lk, pad = 2, 2, 24, 96, 5
    q, k, v, valid = _inputs(g + q_pos0, b, kvh * g, kvh, lq, lk, pad)
    allowed = _mask(valid, q_pos0 + np.arange(lq), lk)
    ref = _jax(q, k, v, allowed)
    out = K2.flash_attention(*map(torch.from_numpy, (q, k, v, valid)), q_pos0, SCALE)
    assert out.shape == (b, kvh * g, lq, D)
    exact = _float64(q, k, v, allowed)
    np.testing.assert_allclose(ref, exact, **F32_TOL, err_msg="JAX vs float64")
    np.testing.assert_allclose(out.numpy(), exact, **F32_TOL, err_msg="port vs float64")
    np.testing.assert_allclose(out.numpy(), ref, **F32_TOL)


def test_f32_tolerance_catches_a_dropped_key():
    """One visible key dropped from the mask of a row that sees few keys
    moves that row's output by more than 10x F32_TOL's limit."""
    b, kvh, lq, lk, pad = 2, 2, 24, 96, 5
    q, k, v, valid = _inputs(7, b, kvh, kvh, lq, lk, pad)
    allowed = _mask(valid, np.arange(lq), lk)
    out = K2.flash_attention(*map(torch.from_numpy, (q, k, v, valid)), 0, SCALE).numpy()
    faulty = allowed.copy()
    row = pad + 5  # sees keys pad .. row except the dropped pad + 3
    faulty[:, :, row, pad + 1] = False
    moved = np.abs(_float64(q, k, v, faulty) - out)[:, :, row].max()
    assert moved > 10 * F32_TOL["atol"], moved
    np.testing.assert_allclose(out, _float64(q, k, v, allowed), **F32_TOL)


def test_flash_fully_masked_rows_are_finite_uniform():
    """Left-pad query rows see no key: their output is the finite uniform
    average of all values (the JAX semantics), never NaN."""
    b, h, kvh, lq, lk, pad = 1, 4, 2, 16, 40, 6
    q, k, v, valid = _inputs(3, b, h, kvh, lq, lk, pad)
    out = K2.flash_attention(*map(torch.from_numpy, (q, k, v, valid)), 0, SCALE).numpy()
    assert np.isfinite(out).all()
    mean_v = np.repeat(v.mean(axis=2), h // kvh, axis=1)  # (B, H, D)
    for i in range(pad):
        np.testing.assert_allclose(out[:, :, i], mean_v, **F32_TOL)
    np.testing.assert_allclose(out, _jax(q, k, v, _mask(valid, np.arange(lq), lk)), **F32_TOL)


@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("lq", [1, 4])
def test_dense_kv_plain_matches_jax(g, lq):
    """Decode over layer ``layer`` of the stacked cache, read in place."""
    nl, b, kvh, lmax, pad, offset, layer = 3, 2, 2, 128, 7, 50, 2
    rng = np.random.default_rng(10 * g + lq)
    ks = rng.standard_normal((nl, b, kvh, lmax, D)).astype(np.float32)
    vs = rng.standard_normal((nl, b, kvh, lmax, D)).astype(np.float32)
    q, _, _, valid = _inputs(lq, b, kvh * g, kvh, lq, lmax, pad)
    ref = _jax(q, ks[layer], vs[layer], _mask(valid, offset + np.arange(lq), lmax))
    out = K3.dense_kv_attention(
        *map(torch.from_numpy, (q, ks, vs, valid)), offset, layer, SCALE
    )
    np.testing.assert_allclose(out.numpy(), ref, **F32_TOL)


def test_dense_kv_plain_bf16_close_to_jax():
    """bf16 inputs: both sides round q * scale to bf16 and the output to
    bf16; the tolerance is two bf16 ulps of O(1) outputs."""
    nl, b, kvh, lmax, offset = 2, 1, 4, 64, 20
    rng = np.random.default_rng(5)
    ks = rng.standard_normal((nl, b, kvh, lmax, D)).astype(np.float32)
    q = rng.standard_normal((b, kvh, 1, D)).astype(np.float32)
    valid = np.ones((b, lmax), bool)
    valid[:, :3] = False
    to_bf = lambda a: torch.from_numpy(a).to(torch.bfloat16)  # noqa: E731
    out = K3.dense_kv_attention(to_bf(q), to_bf(ks), to_bf(ks), torch.from_numpy(valid), offset, 1, SCALE)
    jb = lambda a: jnp.asarray(a).astype(jnp.bfloat16)  # noqa: E731
    ref = JA.masked_attention(
        jb(q), jb(ks[1]), jb(ks[1]), jnp.asarray(_mask(valid, offset + np.arange(1), lmax)), SCALE
    )
    np.testing.assert_allclose(
        out.float().numpy(), np.asarray(ref.astype(jnp.float32)), rtol=2 * 2.0**-8, atol=2e-2
    )


def test_causal_valid_mask():
    valid = torch.tensor([[False, True, True, True, True]])
    m = TA.causal_valid_mask(valid, torch.tensor([1, 3]))
    assert m.shape == (1, 1, 2, 5)
    assert m[0, 0].tolist() == [[False, True, False, False, False], [False, True, True, True, False]]


@pytest.mark.parametrize("offset", [5, torch.tensor([5]), torch.tensor([[5]], dtype=torch.int32),
                                    torch.tensor([5], dtype=torch.int32, device="meta")],
                         ids=["host-int", "int64", "2-d", "other-device"])
def test_k3_k4_take_only_the_device_offset(offset):
    """The kernels read the offset on the device: a host int, or a tensor of
    another dtype, shape or device, is refused, not copied over."""
    K3.check_device_offset(torch.tensor([5], dtype=torch.int32), torch.device("cpu"), "K3")
    with pytest.raises(ValueError, match=r"\(1,\) int32 tensor on cpu"):
        K3.check_device_offset(offset, torch.device("cpu"), "K3")


def test_attention_wrappers_have_no_silent_fallback():
    q = torch.empty((1, 2, 1, D), dtype=torch.bfloat16, device="meta")
    k = torch.empty((1, 1, 2, 8, D), dtype=torch.bfloat16, device="meta")
    valid = torch.empty((1, 8), dtype=torch.bool, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        K2.flash_attention(q, k[0], k[0], valid, 0, SCALE)
    with pytest.raises(RuntimeError, match="no kernel"):
        K3.dense_kv_attention(q, k, k, valid, 0, 0, SCALE)
    payload = torch.empty((1, 1, 1, 8, D), dtype=torch.uint8, device="meta")
    scales = torch.empty((1, 1, 1, 8, 4), dtype=torch.bfloat16, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        K3.quantized_kv_attention(q, payload, scales, valid, 0, 0, SCALE)
    with pytest.raises(RuntimeError, match="no kernel"):
        K3.quantized_flash_attention(q, payload, scales, valid, 0, 0, SCALE)
    assert K2.flash_attention.launches == 0 and K3.dense_kv_attention.launches == 0
    assert K3.quantized_kv_attention.launches == 0 and K3.quantized_flash_attention.launches == 0


# --- the kernels' algorithms, modelled in plain PyTorch (the CUDA kernels run
# only on the card; chip_smoke.py holds them to the plain versions there) ----


def _k3_split_model(q, k_stack, v_stack, valid, offset, layer, scale, row0=0):
    """K3 as the card computes it: each split of the window-only plan gives
    every query row its (max, sum, unnormalized output) over the keys the
    row sees in it — max NEG_INF and sum 0 where it sees none, and a split
    that starts at or past the last row's key reads nothing and writes
    (NEG_INF, 0, 0) — and the merge weighs the splits by exp(max - overall
    max); a row that sees no key anywhere gets the uniform average of all
    Lmax values.  Query row i sits at offset + row0 + i (a later row group
    of a longer pass).  Returns (out, per-split max)."""
    k, v = k_stack[layer].float(), v_stack[layer].float()
    b, h, lq, d = q.shape
    kvh, lmax = k.shape[1], k.shape[2]
    g = h // kvh
    n_split, split = K3.dense_kv_split_plan(lmax)
    kend = min(lmax, offset + row0 + lq)
    qs = (q * scale).float()
    rows = offset + row0 + torch.arange(lq)[:, None]
    ms, ls, accs = [], [], []
    for s in range(n_split):
        j = torch.arange(s * split, max(s * split, min((s + 1) * split, kend)))
        if not len(j):  # the empty partial
            ms.append(torch.full((b, h, lq, 1), TA.NEG_INF))
            ls.append(torch.zeros((b, h, lq, 1)))
            accs.append(torch.zeros((b, h, lq, d)))
            continue
        kk, vv = (t[:, :, j].repeat_interleave(g, dim=1) for t in (k, v))
        seen = valid[:, None, None, j] & (j[None, :] <= rows)[None, None]
        sc = torch.where(seen, qs @ kk.transpose(-1, -2), -torch.inf)
        mx = sc.amax(dim=-1, keepdim=True)
        p = torch.where(seen, torch.exp(sc - mx), 0.0)
        ms.append(torch.where(mx == -torch.inf, TA.NEG_INF, mx))
        ls.append(p.sum(dim=-1, keepdim=True))
        accs.append(p @ vv)
    m_all = torch.stack(ms).amax(dim=0)
    w = [torch.exp(m - m_all) for m in ms]
    out = sum(wi * a for wi, a in zip(w, accs)) / sum(wi * li for wi, li in zip(w, ls)).clamp_min(1e-30)
    uniform = v.mean(dim=2, keepdim=True).repeat_interleave(g, dim=1).expand_as(out)
    return torch.where(m_all > TA.NEG_INF, out, uniform), torch.stack(ms)


SK = K3.K3_SPLIT_KEYS
K3_LMAX = 3 * SK + 128
# (offset of row 0, invalid key ranges) in a window of three splits and a
# part: row 0 just before, at and just after the split boundary 2 * SK, the
# last row at it; a run of invalid keys longer than one split mid-window
# (split 1 wholly masked); rows that see no key at all; rows 0-1 blind, the
# rest not; the window's end.
K3_EDGES = {
    "kend-at-boundary": (lambda lq: 2 * SK - lq, ()),
    "row0-before-boundary": (lambda lq: 2 * SK - 1, ()),
    "row0-at-boundary": (lambda lq: 2 * SK, ()),
    "row0-after-boundary": (lambda lq: 2 * SK + 1, ()),
    "masked-split": (lambda lq: 3 * SK, ((SK - 8, 2 * SK + 44),)),
    "no-visible-key": (lambda lq: SK + 44, ((0, SK + 44 + 16),)),
    "first-rows-blind": (lambda lq: SK + 44, ((0, SK + 46),)),
    "window-end": (lambda lq: K3_LMAX - lq, ((0, 7),)),
}


@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("lq", [1, 4])
@pytest.mark.parametrize("edge", list(K3_EDGES))
def test_k3_split_model_matches_plain(edge, lq, g):
    """The split-and-combine of K3 equals dense_kv_attention_plain (f32) at
    the edges chip_smoke.py checks on the card."""
    nl, b, kvh, lmax, layer = 2, 2, 2, K3_LMAX, 1
    offset_of, holes = K3_EDGES[edge]
    offset = offset_of(lq)
    rng = np.random.default_rng(sorted(K3_EDGES).index(edge) + 10 * lq + 100 * g)
    ks = torch.from_numpy(rng.standard_normal((nl, b, kvh, lmax, D)).astype(np.float32))
    vs = torch.from_numpy(rng.standard_normal((nl, b, kvh, lmax, D)).astype(np.float32))
    q = torch.from_numpy(rng.standard_normal((b, kvh * g, lq, D)).astype(np.float32))
    valid = torch.from_numpy(rng.random((b, lmax)) > 0.05)
    for lo, hi in holes:
        valid[:, lo:hi] = False
    out, ms = _k3_split_model(q, ks, vs, valid, offset, layer, SCALE)
    ref = K3.dense_kv_attention_plain(q, ks, vs, valid, offset, layer, SCALE)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), **F32_TOL)
    n_split, split = K3.dense_kv_split_plan(lmax)
    assert len(ms) == n_split
    for s in range(n_split):  # a split at or past the last row's key is empty
        if s * split >= offset + lq:
            assert (ms[s] == TA.NEG_INF).all()
    if edge == "masked-split":
        assert (ms[1] == TA.NEG_INF).all()
        assert (ms[0] > TA.NEG_INF).all() and (ms[2] > TA.NEG_INF).all()
    if edge == "no-visible-key":
        assert (ms == TA.NEG_INF).all()
        mean_v = vs[layer].mean(dim=2).repeat_interleave(g, dim=1)
        for i in range(lq):
            np.testing.assert_allclose(ref[:, :, i].numpy(), mean_v.numpy(), **F32_TOL)


@pytest.mark.parametrize("lmax", [64, 640, 768, 4352])
def test_k3_split_plan_covers_each_key_once(lmax):
    """The plan depends on the window only (a captured launch replays at any
    offset): its splits tile the window, every key up to the last row's
    position falls in exactly one split's read range, the splits past it
    read nothing (their empty partials), and no split reaches past the
    window."""
    n_split, split = K3.dense_kv_split_plan(lmax)
    assert split == SK and n_split == -(-lmax // SK) and (n_split - 1) * split < lmax
    for lq in (1, 4, 16):
        for offset in sorted({0, 1, SK - 1, SK, SK + 1, lmax // 2, lmax - lq, lmax - 1, lmax + 5}):
            kend = min(lmax, offset + lq)
            covered = np.zeros(lmax, int)
            for s in range(n_split):
                lo, hi = s * split, min((s + 1) * split, kend)
                if lo >= kend:
                    assert hi <= lo  # an empty split
                    continue
                assert lo < hi <= lmax
                covered[lo:hi] += 1
            assert (covered[:kend] == 1).all() and (covered[kend:] == 0).all()
            assert kend - 1 == min(lmax - 1, offset + lq - 1)


@pytest.mark.parametrize("lq", [1, 4])
@pytest.mark.parametrize("offset", [0, 5, SK + 3])
def test_k3_split_model_short_offset_long_window(offset, lq):
    """A short offset in a 4352-key window: the window-only plan's 68 splits,
    all but the first one or two empty, still give the plain version (f32);
    batch row 1 has no valid key and keeps the uniform average of all 4352
    values; the device offset (a (1,) int32 tensor) gives what the host int
    gives."""
    nl, b, kvh, lmax, layer = 1, 2, 2, 4352, 0
    rng = np.random.default_rng(1000 + 10 * offset + lq)
    ks = torch.from_numpy(rng.standard_normal((nl, b, kvh, lmax, D)).astype(np.float32))
    vs = torch.from_numpy(rng.standard_normal((nl, b, kvh, lmax, D)).astype(np.float32))
    q = torch.from_numpy(rng.standard_normal((b, 2 * kvh, lq, D)).astype(np.float32))
    valid = torch.from_numpy(rng.random((b, lmax)) > 0.05)
    valid[1] = False
    out, ms = _k3_split_model(q, ks, vs, valid, offset, layer, SCALE)
    ref = K3.dense_kv_attention_plain(q, ks, vs, valid, offset, layer, SCALE)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), **F32_TOL)
    live = -(-(offset + lq) // SK)
    assert len(ms) == 68 and (ms[live:] == TA.NEG_INF).all() and (ms[:live, 1] == TA.NEG_INF).all()
    mean_v = vs[layer, 1].mean(dim=1).repeat_interleave(2, dim=0)
    for i in range(lq):
        np.testing.assert_allclose(ref[1, :, i].numpy(), mean_v.numpy(), **F32_TOL)
    dev_off = torch.tensor([offset], dtype=torch.int32)
    assert torch.equal(K3.dense_kv_attention(q, ks, vs, valid, dev_off, layer, SCALE), ref)


@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("lq,row0", [(16, 16), (1, 32), (16, 0)])
def test_k3_split_model_row0_matches_plain(lq, row0, g):
    """A launch on a later row group of a verify pass (row0 > 0, the cases
    chip_smoke.py checks on the card): query i at offset + row0 + i, in the
    split model and the plain version alike; the keys up to offset + row0
    are the earlier groups' and the committed ones."""
    nl, b, kvh, lmax, layer, offset = 2, 2, 2, K3_LMAX, 1, SK + 5
    rng = np.random.default_rng(7 + lq + row0 + 100 * g)
    ks = torch.from_numpy(rng.standard_normal((nl, b, kvh, lmax, D)).astype(np.float32))
    vs = torch.from_numpy(rng.standard_normal((nl, b, kvh, lmax, D)).astype(np.float32))
    q = torch.from_numpy(rng.standard_normal((b, kvh * g, lq, D)).astype(np.float32))
    valid = torch.from_numpy(rng.random((b, lmax)) > 0.05)
    out, ms = _k3_split_model(q, ks, vs, valid, offset, layer, SCALE, row0)
    ref = K3.dense_kv_attention_plain(q, ks, vs, valid, offset, layer, SCALE, row0)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), **F32_TOL)
    live = -(-(offset + row0 + lq) // SK)
    assert (ms[:live] > TA.NEG_INF).any() and (ms[live:] == TA.NEG_INF).all()
    earlier = torch.from_numpy(rng.standard_normal((b, kvh * g, row0, D)).astype(np.float32))
    whole = K3.dense_kv_attention_plain(torch.cat([earlier, q], dim=2), ks, vs, valid, offset, layer,
                                        SCALE)
    np.testing.assert_allclose(ref.numpy(), whole[:, :, row0:].numpy(), **F32_TOL)


@pytest.mark.parametrize("lq", [16, 17, 33])
def test_row_groups_equal_one_pass(lq):
    """``by_row_groups``: a pass of Lq rows as launches on groups of 16 rows,
    each with its row0, equals the plain version over all Lq rows at once
    (single-stream K3 and K4 alike)."""
    nl, b, kvh, lmax, layer, offset = 1, 2, 2, 128, 0, 40
    rng = np.random.default_rng(lq)
    ks = torch.from_numpy(rng.standard_normal((nl, b, kvh, lmax, D)).astype(np.float32))
    vs = torch.from_numpy(rng.standard_normal((nl, b, kvh, lmax, D)).astype(np.float32))
    q = torch.from_numpy(rng.standard_normal((b, 2 * kvh, lq, D)).astype(np.float32))
    valid = torch.from_numpy(rng.random((b, lmax)) > 0.1)
    calls = []

    def k3(q_, *args, row0=0):
        calls.append((q_.shape[2], row0))
        return K3.dense_kv_attention(q_, *args, row0=row0)

    got = K3.by_row_groups(k3, q, ks, vs, valid, torch.tensor([offset], dtype=torch.int32), layer, SCALE)
    assert calls == [(min(16, lq - r), r) for r in range(0, lq, 16)]
    want = K3.dense_kv_attention_plain(q, ks, vs, valid, offset, layer, SCALE)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **F32_TOL)


def _tf32(x):
    """x rounded to tf32 (10 mantissa bits), to nearest with ties away from
    zero: the card's ``cvt.rna.tf32.f32``."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _mm_3xtf32(a, b):
    """a @ b as fp32 K2's tensor cores compute it: each operand split into
    tf32 parts hi + lo, then a_lo b_hi + a_hi b_lo + a_hi b_hi with f32 sums
    (every tf32 product is exact in f32; a_lo b_lo is dropped)."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _mm_3xtf32_steps(a, b, steps, apart=False):
    """a @ b as the 3xTF32 ``mma.sync.m16n8k8`` k-steps of a kernel walk it:
    k-step i takes columns ``steps[i]`` of a and the same rows of b, and adds
    a_lo b_hi, a_hi b_lo and a_hi b_hi to the f32 sum in that order;
    ``apart``: hi * hi in one sum and the lo terms in another, added at the
    end (the split-run body's scores)."""
    hi = torch.zeros(a.shape[:-1] + b.shape[-1:])
    lo = torch.zeros_like(hi)
    for idx in steps:
        ak, bk = a[..., idx], b[..., idx, :]
        ah, bh = _tf32(ak), _tf32(bk)
        al, bl = _tf32(ak - ah), _tf32(bk - bh)
        if apart:
            lo = lo + al @ bh + ah @ bl
            hi = hi + ah @ bh
        else:
            hi = hi + al @ bh + ah @ bl + ah @ bh
    return hi + lo


def _f32_qk_steps(d, loader):
    """The dims that each k-step of the fp32 split-run body's Q K^T takes, by
    loader: ``"int4"`` (``Int4RunF32``: k slots t and t + 4 of k-step kk
    stand for dims d/4 t + 2 kk and + 1), ``"dense"`` (``DenseRunF32``: dims
    8 kk + 2 t and + 1, so k-step kk is dims 8 kk .. 8 kk + 7)."""
    if loader == "dense":
        return [torch.arange(8 * kk, 8 * kk + 8) for kk in range(d // 8)]
    return [torch.tensor([d // 4 * t + 2 * kk + w for t in range(4) for w in range(2)]) for kk in range(d // 8)]


def _key_steps(n):
    """P V's k-steps over a run's ``n`` keys: eight keys each (k slots t and
    t + 4 stand for keys 8 j + t and + 4)."""
    return [torch.arange(j, min(j + 8, n)) for j in range(0, n, 8)]


def _k2_tile_model(q, k, v, valid, q_pos0, scale, round_p, tile=64, tf32x3=False):
    """K2 as the card computes it: ``tile``-row query tiles (64 in bf16 and
    fp32), key tiles of as many keys, one max and one rescale per key tile,
    tiles past the query tile's causal horizon skipped unless a row has
    seen no visible key; ``round_p`` rounds the softmax weights to bf16
    before p @ v (the row sums stay f32); ``tf32x3`` runs both products as
    fp32 K2's 3xTF32 (P split, never rounded below f32), each tile's p @ v
    summed on its own before it joins the rescaled output."""
    b, h, lq, d = q.shape
    kvh, lk = k.shape[1], k.shape[2]
    mm = _mm_3xtf32 if tf32x3 else torch.matmul
    qs, k, v = (q * scale).float(), k.float(), v.float()
    out = torch.empty((b, h, lq, d))
    for bi in range(b):
        for hi in range(h):
            kh, vh = k[bi, hi // (h // kvh)], v[bi, hi // (h // kvh)]
            for i0 in range(0, lq, tile):
                qi = torch.arange(i0, min(i0 + tile, lq))
                horizon = q_pos0 + min(lq, i0 + tile) - 1
                m = torch.full((len(qi),), TA.NEG_INF)
                l = torch.zeros(len(qi))
                acc = torch.zeros((len(qi), d))
                for j0 in range(0, lk, tile):
                    if j0 > horizon and not (m == TA.NEG_INF).any():
                        break
                    j = torch.arange(j0, min(j0 + tile, lk))
                    ok = valid[bi, j][None, :] & (j[None, :] <= q_pos0 + qi[:, None])
                    s = torch.where(ok, mm(qs[bi, hi, qi], kh[j].T), TA.NEG_INF)
                    m_new = torch.maximum(m, s.amax(dim=-1))
                    alpha = torch.exp(m - m_new)
                    p = torch.exp(s - m_new[:, None])
                    l = l * alpha + p.sum(dim=-1)
                    pv = p.to(torch.bfloat16).float() if round_p else p
                    acc = acc * alpha[:, None] + mm(pv, vh[j])
                    m = m_new
                out[bi, hi, qi] = acc / torch.where(l == 0, 1.0, l)[:, None]
    return out


def test_tf32_split_is_exact_to_2_22():
    """tf32 rounds to nearest on 10 mantissa bits (ties away from zero), and
    hi + lo holds an f32 value to 2^-22 of itself: 3xTF32's operands."""
    x = torch.tensor([1.0, 1 + 2.0**-11, -(1 + 2.0**-11), 1 + 2.0**-10 + 2.0**-11, 1 + 2.0**-12])
    assert _tf32(x).tolist() == [1.0, 1 + 2.0**-10, -(1 + 2.0**-10), 1 + 2.0**-9, 1.0]
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.standard_normal(100000) * 10.0 ** rng.integers(-6, 6, 100000))
                         .astype(np.float32))
    hi = _tf32(x)
    lo = _tf32(x - hi)
    assert ((hi.view(torch.int32) & 0x1FFF) == 0).all() and ((lo.view(torch.int32) & 0x1FFF) == 0).all()
    err = ((hi.double() + lo.double()) - x.double()).abs() / x.double().abs()
    assert err.max() <= 2.0**-22
    assert err.max() > 2.0**-25  # lo's own rounding is real


def test_3xtf32_products_keep_f32_accuracy():
    """Against float64, a 64 x 96 by 96 x 64 product in 3xTF32 errs about as
    much as in f32, where plain TF32 (one product) errs over 100x more."""
    rng = np.random.default_rng(1)
    a = torch.from_numpy(rng.standard_normal((64, 96)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((96, 64)).astype(np.float32))
    exact = a.double() @ b.double()
    err = lambda x: (x.double() - exact).abs().max().item()
    f32 = err(a @ b)
    assert err(_mm_3xtf32(a, b)) <= 2 * f32
    assert err(_tf32(a) @ _tf32(b)) > 100 * f32


# (lq, q_pos0, lk, left pads per batch row): prompts left-padded differently
# in one batch, an extend chunk at q_pos0 = 1000, lq and lk off the tiles.
K2_EDGES = {
    "batch-pads": (130, 0, 200, (0, 70)),
    "extend": (100, 1000, 1130, (12, 40)),
    "ragged": (77, 3, 145, (5, 0)),
}


@pytest.mark.parametrize("round_p", [False, True])
@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("edge", list(K2_EDGES))
def test_k2_tile_model_matches_plain(edge, g, round_p):
    """K2's tiling, masking and causal skipping equal flash_attention_plain
    in f32; with p rounded to bf16 (the card's P V operand) they stay within
    chip_smoke.py's limits for the card, ATTN_ATOL + ATTN_RTOL * |ref|."""
    lq, q_pos0, lk, pads = K2_EDGES[edge]
    b, kvh = len(pads), 2
    rng = np.random.default_rng(len(edge) + 10 * g)
    q = torch.from_numpy(rng.standard_normal((b, kvh * g, lq, D)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((b, kvh, lk, D)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((b, kvh, lk, D)).astype(np.float32))
    valid = torch.ones((b, lk), dtype=torch.bool)
    for bi, pad in enumerate(pads):
        valid[bi, :pad] = False
    valid[:, lk // 2] = False
    out = _k2_tile_model(q, k, v, valid, q_pos0, SCALE, round_p)
    ref = K2.flash_attention_plain(q, k, v, valid, q_pos0, SCALE)
    if round_p:
        np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=2 * 2.0**-7, atol=2e-3)
        assert (out - ref).abs().max() > 0  # the rounding is real
    else:
        np.testing.assert_allclose(out.numpy(), ref.numpy(), **F32_TOL)
    if q_pos0 == 0:  # left-pad rows see no key: the uniform average of all lk values
        for bi, pad in enumerate(pads):
            mean_v = v[bi].mean(dim=1).repeat_interleave(g, dim=0)
            for i in range(pad):
                np.testing.assert_allclose(out[bi, :, i].numpy(), mean_v.numpy(), **F32_TOL)
