"""The plain versions of kernels K6 and K7 (``ops/kernels/kv_attention.py``)
against the JAX package's paged kernels in interpret mode, on the CPU.

One layer's page pool is made in the JAX layout from numpy (the int4 pool
by the JAX quantizer: transposed, head dim permuted) and reaches the port's
layout through ``core/convert.py:from_jax_paged_pool``, stacked behind a
decoy layer so that the layer index is exercised.  The port's wrappers run
their plain versions on CPU tensors.  Each case covers ragged offsets across
slots, table tails at the sentinel, a partly filled last page and a
left-padded, holed validity row whose bits past the offset are random (the
fresh-region rule must ignore them); Lq = 1 is a decode step and Lq = 4 the
fresh region of several queries.  A plain-PyTorch model of the card's K6
and K7 (their split plan, runs and merge) is held to the plain versions at
the end.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from test_torch_attention import F32_TOL  # noqa: E402

from phi_3_vision_mlx_tpu.core.config import KVQuantConfig  # noqa: E402
from phi_3_vision_mlx_tpu.engine import state as JS  # noqa: E402
from phi_3_vision_mlx_tpu.ops.kernels import kv_attention as JK  # noqa: E402
from phi_3_vision_mlx_tpu_torch.core.convert import from_jax_paged_pool  # noqa: E402
from phi_3_vision_mlx_tpu_torch.ops.kernels import kv_attention as TK  # noqa: E402

# Both sides round to bf16 at different points (the TPU kernels round p
# before P.V and scale after Q.K; the plain versions round q * scale and
# keep p in f32), as for K4/K5 in tests/test_torch_kv_quant.py.
KERNEL_TOL = dict(rtol=2e-2, atol=2e-2)

CASES = {
    # name: (d, heads, kv heads, page, pages per slot, offsets)
    "D32-page16": (32, 4, 2, 16, 6, (5, 37, 70, 90)),
    "D96-page64": (96, 2, 1, 64, 4, (100, 63, 200, 130)),
}


def _case(name, lq, seed=0):
    d, h, kvh, page, mp, offsets = CASES[name]
    rng = np.random.default_rng(seed)
    s, w = len(offsets), mp * page
    need = [-(-(o + lq) // page) for o in offsets]
    n_pages = sum(need) + 2  # two pages no slot owns
    tables = np.full((s, mp), n_pages, np.int32)  # the sentinel
    ids = iter(rng.permutation(n_pages))
    for i, n in enumerate(need):
        tables[i, :n] = [next(ids) for _ in range(n)]
    valid = rng.random((s, w)) > 0.15
    valid[:, :3] = False  # left padding
    k = (rng.standard_normal((n_pages, kvh, page, d)) * 1.5 + 0.7).astype(np.float32)
    v = (rng.standard_normal((n_pages, kvh, page, d)) - 0.4).astype(np.float32)
    q = rng.standard_normal((s, h, lq, d)).astype(np.float32)
    return q, k, v, tables, valid, np.asarray(offsets, np.int32)


def _bf16(a):
    return torch.from_numpy(a).to(torch.bfloat16)


def _stack(t):
    """A decoy layer 0 in front of the pool, read at layer 1."""
    return torch.stack([torch.full_like(t, 7), t]).contiguous()


@pytest.mark.parametrize("lq", [1, 4])
@pytest.mark.parametrize("name", list(CASES))
def test_plain_k6_matches_jax_kernel(name, lq):
    q, k, v, tables, valid, offsets = _case(name, lq)
    q16, k16, v16 = (_bf16(a) for a in (q, k, v))
    scale = q.shape[-1] ** -0.5
    want = JK.paged_kv_attention(
        jnp.asarray(q16.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(k16.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(v16.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(tables), jnp.asarray(valid), jnp.asarray(offsets), scale=scale, interpret=True)
    pk, pv = from_jax_paged_pool(k16.float().numpy(), v16.float().numpy(), dtype=torch.bfloat16)
    assert pk.shape == (k.shape[0] + 1, *k.shape[1:]) and not pk[-1].any()
    got = TK.paged_kv_attention(q16, _stack(pk), _stack(pv), torch.from_numpy(tables),
                                torch.from_numpy(valid), torch.from_numpy(offsets), 1, scale)
    assert got.shape == q.shape and got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               **KERNEL_TOL)


@pytest.mark.parametrize("lq", [1, 4])
@pytest.mark.parametrize("name", list(CASES))
def test_plain_k7_matches_jax_kernel(name, lq):
    q, k, v, tables, valid, offsets = _case(name, lq, seed=1)
    d = q.shape[-1]
    e = JS.quantize_chunk(jnp.asarray(k), jnp.asarray(v), KVQuantConfig(bits=4), True)
    groups = e.k_scales.shape[-2] // 4
    scale = d**-0.5
    q16 = _bf16(q)
    qj = jnp.asarray(q16.float().numpy()).astype(jnp.bfloat16)
    want = JK.paged_quantized_kv_attention(
        qj[..., JK.d_perm(d, groups)], e.k, e.k_scales, jnp.asarray(tables), jnp.asarray(valid),
        jnp.asarray(offsets), scale=scale, interpret=True)[..., JK.d_unperm(d, groups)]
    payload, scales = from_jax_paged_pool(np.asarray(e.k), np.asarray(e.k_scales.astype(jnp.float32)),
                                          quantized=True)
    assert payload.shape == (k.shape[0] + 1, *k.shape[1:]) and scales.shape[-1] == 4 * groups
    got = TK.paged_quantized_kv_attention(q16, _stack(payload), _stack(scales),
                                          torch.from_numpy(tables), torch.from_numpy(valid),
                                          torch.from_numpy(offsets), 1, scale)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               **KERNEL_TOL)


def test_plain_k7_is_k6_over_the_dequantized_pool():
    """K7's plain version reads the int4 pool as K6 reads the pool that
    ``dequantize_kv`` makes of it, to the bit."""
    q, k, v, tables, valid, offsets = _case("D96-page64", 4, seed=2)
    e = JS.quantize_chunk(jnp.asarray(k), jnp.asarray(v), KVQuantConfig(bits=4), True)
    payload, scales = from_jax_paged_pool(np.asarray(e.k), np.asarray(e.k_scales.astype(jnp.float32)),
                                          quantized=True)
    from phi_3_vision_mlx_tpu_torch.engine.state import dequantize_kv

    kd, vd = dequantize_kv(payload, scales, torch.bfloat16)
    args = (torch.from_numpy(tables), torch.from_numpy(valid), torch.from_numpy(offsets), 0, 0.1)
    q16 = _bf16(q)
    assert torch.equal(TK.paged_quantized_kv_attention(q16, payload[None], scales[None], *args),
                       TK.paged_kv_attention(q16, kd[None], vd[None], *args))


def test_fresh_region_rule():
    """Keys from the offset to the query's own position are visible whatever
    their validity bits; keys before the offset need their bit; keys past
    the query are hidden."""
    valid = torch.tensor([[True, False, True, False, False, True, True, True]])
    vis = TK.paged_visible(valid, torch.tensor([3], dtype=torch.int32), 3)[0, 0]
    assert vis.tolist() == [
        [True, False, True, True, False, False, False, False],
        [True, False, True, True, True, False, False, False],
        [True, False, True, True, True, True, False, False],
    ]


def test_launch_counts_survive_threads():
    """The continuous server launches from two threads: counting is
    thread-safe (eight threads switching every microsecond lose no count)."""
    import sys
    import threading

    from phi_3_vision_mlx_tpu_torch.ops.kernels import _build

    def wrapper():
        pass

    wrapper.launches = 0
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [_build.count_launch(wrapper) for _ in range(2000)])
                   for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    assert wrapper.launches == 8 * 2000


def test_wrappers_raise_without_a_kernel():
    """A device other than the CPU or CUDA has no kernel: the wrappers raise
    instead of running the plain version."""
    q = torch.empty((1, 2, 1, 96), device="meta", dtype=torch.bfloat16)
    pool = torch.empty((1, 3, 1, 64, 96), device="meta", dtype=torch.bfloat16)
    args = (torch.empty((1, 2), dtype=torch.int32, device="meta"),
            torch.empty((1, 128), dtype=torch.bool, device="meta"),
            torch.empty((1,), dtype=torch.int32, device="meta"), 0, 0.1)
    with pytest.raises(RuntimeError, match="no kernel"):
        TK.paged_kv_attention(q, pool, pool, *args)
    with pytest.raises(RuntimeError, match="no kernel"):
        TK.paged_quantized_kv_attention(q, pool, pool, *args)


# --- K6 and K7 on the card: runs of the split plan, all of a slot's rows in
# one block, merged up to each row's last visible key
# (csrc/paged_kv_attention.cu), modelled in plain PyTorch.  chip_smoke.py
# holds the kernels to their plain versions there.


def _paged_split_model(q, k, v, tables, valid, offsets, scale):
    """K6 and K7 as the card computes them, over one layer's pool of keys
    and values ``(P1, KV, page, D)`` (K7's dequantized).  Each run of
    ``paged_split_plan`` gives every row of a slot its (max, sum,
    unnormalized output) over the keys the row sees in the run — max NEG_INF
    and sum 0 where it sees none; the output's weights enter as bf16 hi + lo
    (hi = bf16(p), lo = bf16(p - hi)), the sum as f32 p; a run at or past the
    slot's ``min(W, offset + Lq)`` is empty.  A row's merge reads its runs up
    to its last visible key ``offset + i`` and weighs them by exp(max - their
    max); a row that sees no key gets the uniform average of every value of
    its window.  Each key's row comes from the table, clamped into the pool.
    Returns (out, live runs per (slot, row))."""
    from phi_3_vision_mlx_tpu_torch.ops.attention import NEG_INF

    s_, h, lq, d = q.shape
    p1, kvh, page = k.shape[:3]
    w = tables.shape[1] * page
    n_split, split = TK.paged_split_plan(w)
    qs = (q * scale).float()
    out = torch.empty((s_, h, lq, d))
    live = torch.empty((s_, lq), dtype=torch.long)
    for s in range(s_):
        off = int(offsets[s])
        pid = tables[s].long().clamp(0, p1 - 1).repeat_interleave(page)
        row = torch.arange(w) % page
        ks, vs = (t[pid, :, row].transpose(0, 1).float().repeat_interleave(h // kvh, dim=0) for t in (k, v))
        ms, ls, accs = [], [], []
        for r in range(n_split):
            j = torch.arange(r * split, max(r * split, min((r + 1) * split, w, off + lq)))
            seen = (valid[s, j] | (j >= off))[None, :] & (j[None, :] <= off + torch.arange(lq)[:, None])
            sc = torch.where(seen, qs[s] @ ks[:, j].transpose(-1, -2), -torch.inf)  # (H, Lq, n)
            mx = sc.amax(dim=-1, keepdim=True) if len(j) else torch.full((h, lq, 1), -torch.inf)
            p = torch.where(seen, torch.exp(sc - mx), 0.0)
            ms.append(torch.where(mx == -torch.inf, NEG_INF, mx))
            ls.append(p.sum(dim=-1, keepdim=True))
            hi = p.to(torch.bfloat16).float()
            accs.append((hi + (p - hi).to(torch.bfloat16).float()) @ vs[:, j])
        for i in range(lq):
            live[s, i] = n = min(n_split, min(w - 1, off + i) // split + 1)
            m_all = torch.stack([m[:, i] for m in ms[:n]]).amax(dim=0)
            wt = [torch.exp(m[:, i] - m_all) for m in ms[:n]]
            o = sum(a * acc[:, i] for a, acc in zip(wt, accs)) / sum(a * l_[:, i] for a, l_ in zip(wt, ls))
            out[s, :, i] = torch.where(m_all > NEG_INF, o, vs.mean(dim=1))
    return out, live


def _k7_split_model(q, payload, scales, tables, valid, offsets, layer, scale):
    """K7: the int4 pool's layer dequantized once (``Int4Run``'s tiles),
    then the runs and merge of :func:`_paged_split_model`."""
    from phi_3_vision_mlx_tpu_torch.engine.state import dequantize_kv

    k, v = dequantize_kv(payload[layer], scales[layer], q.dtype)  # (P1, KV, page, D)
    return _paged_split_model(q, k, v, tables, valid, offsets, scale)


# (spare pages withheld from the table, offsets): slot 0 past its window
# with no valid key (no visible key at all), slot 1 at offset 0 (fresh keys
# only), slot 2's rows across a run boundary, slot 3 reading the spare page
# inside its visible range.
K7_OFFSETS = (160, 0, 62, 100)


@pytest.mark.parametrize("lq", [1, 4, 16])
def test_k7_split_model_matches_plain(lq):
    """K7's runs and merge equal paged_quantized_kv_attention_plain (f32) at
    ragged offsets, a row that sees no key and table entries at the spare
    page; the merge never reads a run the split kernel left empty."""
    from phi_3_vision_mlx_tpu_torch.core.config import KVQuantConfig as TKVQ
    from phi_3_vision_mlx_tpu_torch.engine.state import quantize_chunk

    rng = np.random.default_rng(lq)
    d, h, kvh, page, mp = 96, 4, 2, 16, 10  # a window of 160: runs of 64, 64 and 32 keys
    s_, w = len(K7_OFFSETS), mp * page
    n_pages = 24
    tables = np.full((s_, mp), n_pages, np.int32)  # the spare page
    ids = iter(rng.permutation(n_pages))
    for i, off in enumerate(K7_OFFSETS):
        need = min(mp, -(-(off + lq) // page)) - (i == 3)  # slot 3: its last page left at the spare
        tables[i, :need] = [next(ids) for _ in range(need)]
    valid = torch.from_numpy(rng.random((s_, w)) > 0.15)
    valid[:, :3] = False  # left padding
    valid[0] = False
    k = torch.from_numpy((rng.standard_normal((2, n_pages + 1, kvh, page, d)) * 1.5 + 0.7).astype(np.float32))
    v = torch.from_numpy((rng.standard_normal((2, n_pages + 1, kvh, page, d)) - 0.4).astype(np.float32))
    payload, scales = quantize_chunk(k, v, TKVQ(group_size=32, bits=4))
    q = torch.from_numpy(rng.standard_normal((s_, h, lq, d)).astype(np.float32))
    args = (torch.from_numpy(tables), valid, torch.tensor(K7_OFFSETS, dtype=torch.int32), 1, d**-0.5)
    out, live = _k7_split_model(q, payload, scales, *args)
    ref = TK.paged_quantized_kv_attention_plain(q, payload, scales, *args)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), **F32_TOL)
    n_split, split = TK.paged_split_plan(w)
    kend = [min(w, off + lq) for off in K7_OFFSETS]
    for s in range(s_):  # every run the merge reads holds keys of the slot
        assert all((live[s, i] - 1) * split < kend[s] for i in range(lq))
    if lq == 16:
        assert live[2].tolist() == [1, 1] + [2] * 14  # rows 0-1 end in run 0, the rest in run 1
        vis = TK.paged_visible(valid, args[2], lq)[0, 0]
        assert not vis.any()  # slot 0 sees no key: the uniform average
        assert (torch.from_numpy(tables[3]) == n_pages).any()


@pytest.mark.parametrize("window", [16, 64, 160, 1000, 1024])
def test_paged_split_plan_covers_each_visible_key_once(window):
    """Each key of the window falls in exactly one run, each run is
    non-empty, and the plan takes only the window: for any offset and Lq,
    the runs holding some key a row can see are those a merge reads."""
    n_split, split = TK.paged_split_plan(window)
    assert split == TK.PAGED_RUN_KEYS
    covered = np.zeros(window, int)
    for r in range(n_split):
        lo, hi = r * split, min((r + 1) * split, window)
        assert lo < hi
        covered[lo:hi] += 1
    assert (covered == 1).all()
    for lq in (1, 4, 16):
        for off in sorted({0, 1, split - 1, split, window // 2, window - lq, window - 1, window + 3}):
            kend = min(window, off + lq)
            runs = {j // split for j in range(kend)}
            assert runs == set(range(min(n_split, (min(window - 1, off + lq - 1)) // split + 1)))


@pytest.mark.parametrize("lq", [1, 4, 16])
def test_k6_split_model_matches_plain(lq):
    """K6's runs over the dense pool (``DenseRun`` copies the bf16 rows as
    they are) and merge equal paged_kv_attention_plain (f32) at K7's edges:
    ragged offsets, a row that sees no key, fresh keys only, rows across a
    run boundary and table entries at the spare page; and table entries
    outside [0, P], which the kernel clamps into the pool, equal the plain
    version over the clamped table."""
    rng = np.random.default_rng(10 + lq)
    d, h, kvh, page, mp = 96, 4, 2, 16, 10  # a window of 160: runs of 64, 64 and 32 keys
    s_, w = len(K7_OFFSETS), mp * page
    n_pages = 24
    tables = np.full((s_, mp), n_pages, np.int32)  # the spare page
    ids = iter(rng.permutation(n_pages))
    for i, off in enumerate(K7_OFFSETS):
        need = min(mp, -(-(off + lq) // page)) - (i == 3)  # slot 3: its last page left at the spare
        tables[i, :need] = [next(ids) for _ in range(need)]
    bad = tables.copy()
    bad[3, 0], bad[2, 1], bad[1, 0] = n_pages + 9, -4, -1  # all inside the slots' visible keys
    valid = torch.from_numpy(rng.random((s_, w)) > 0.15)
    valid[:, :3] = False  # left padding
    valid[0] = False
    pool = [torch.from_numpy((rng.standard_normal((2, n_pages + 1, kvh, page, d)) * a + c).astype(np.float32))
            for a, c in ((1.5, 0.7), (1.0, -0.4))]
    q = torch.from_numpy(rng.standard_normal((s_, h, lq, d)).astype(np.float32))
    offsets = torch.tensor(K7_OFFSETS, dtype=torch.int32)
    out, live = _paged_split_model(q, pool[0][1], pool[1][1], torch.from_numpy(bad), valid, offsets, d**-0.5)
    clamped = torch.from_numpy(bad).clamp(0, n_pages)
    ref = TK.paged_kv_attention_plain(q, *pool, clamped, valid, offsets, 1, d**-0.5)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), **F32_TOL)
    assert not torch.equal(clamped, torch.from_numpy(tables))  # the clamp changed what is read
    same, _ = _paged_split_model(q, pool[0][1], pool[1][1], clamped, valid, offsets, d**-0.5)
    assert torch.equal(out, same)
    assert not TK.paged_visible(valid, offsets, lq)[0, 0].any()  # slot 0 sees no key
    if lq == 16:
        assert live[2].tolist() == [1, 1] + [2] * 14
