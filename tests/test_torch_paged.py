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
fresh region of several queries.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

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
