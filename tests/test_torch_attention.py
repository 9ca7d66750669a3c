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
