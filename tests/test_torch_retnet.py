"""The port's byte-level RetNet (``models/retnet.py``) against the JAX
package in fp32: the byte codec, both forms, their equality, training and
greedy generation, from the same weights (JAX's ``init_params`` carried
over with ``core/convert.py:from_numpy_f32_tree``)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from phi_3_vision_mlx_tpu.models import retnet as JR  # noqa: E402
from phi_3_vision_mlx_tpu_torch.core.convert import from_numpy_f32_tree  # noqa: E402
from phi_3_vision_mlx_tpu_torch.models import retnet as TR  # noqa: E402
from test_torch_model import one_thread  # noqa: E402,F401

SIZES = dict(hidden_size=64, intermediate_size=128, num_hidden_layers=2, num_heads=4)  # tests/test_retnet.py
JCFG, CFG = JR.RetNetConfig(**SIZES), TR.RetNetConfig(**SIZES)
IDS = np.array([[256, 72, 101, 108, 108, 111, 44, 32, 119, 111, 114, 108, 100]])  # BOS + b"Hello, world"
FP32_ATOL = 2e-5  # logits of O(1), the same f32 math summed in another order (measured 3e-6)
FORMS_TOL = 2e-4  # parallel against recurrent (tests/test_retnet.py)
LOSS_RTOL = 1e-4  # 60 Adam steps: the rounding compounds (measured 2e-5)


@pytest.fixture(scope="module")
def params():
    pj = JR.init_params(JCFG, jax.random.PRNGKey(1))
    return pj, from_numpy_f32_tree(jax.tree_util.tree_map(np.asarray, pj))


def test_byte_roundtrip():
    s = "héllo ⚡"
    assert TR.encode_bytes(s) == JR.encode_bytes(s) and TR.encode_bytes(s, add_bos=False) == JR.encode_bytes(
        s, add_bos=False)
    assert TR.decode_bytes(TR.encode_bytes(s, add_bos=False)) == s
    assert TR.decode_bytes([256, 104, 105, 257]) == JR.decode_bytes([256, 104, 105, 257]) == "hi"
    assert (TR.BOS, TR.VOCAB) == (JR.BOS, JR.VOCAB)


def test_init_params_has_the_jax_tree():
    tp = TR.init_params(CFG, torch.Generator().manual_seed(0))
    jp = JR.init_params(JCFG, jax.random.PRNGKey(0))
    assert tp.keys() == jp.keys() and len(tp["layers"]) == len(jp["layers"])
    for a, b in zip(tp["layers"], jp["layers"]):
        assert {k: tuple(v.shape) for k, v in a.items()} == {k: tuple(v.shape) for k, v in b.items()}
    for k in ("embed", "norm_f", "lm_head"):
        assert tuple(tp[k].shape) == tuple(jp[k].shape) and tp[k].dtype == torch.float32
    state = TR.init_state(CFG, 3, tp)
    assert tuple(state.s.shape) == tuple(JR.init_state(JCFG, 3).s.shape) and int(state.pos) == 0
    on_meta = TR.init_state(CFG, 3, {"embed": torch.empty(1, device="meta")})  # the carry follows the params
    assert on_meta.s.device.type == on_meta.pos.device.type == "meta"


def test_decays_and_rotation_match_jax():
    np.testing.assert_array_equal(TR._decays(CFG).numpy(), np.asarray(JR._decays(JCFG)))
    x = np.random.default_rng(0).standard_normal((2, 4, 5, 16)).astype(np.float32)
    pos = np.arange(3, 8)[None].repeat(2, 0)
    np.testing.assert_allclose(TR._rotate(torch.as_tensor(x), torch.as_tensor(pos)).numpy(),
                               np.asarray(JR._rotate(jnp.asarray(x), jnp.asarray(pos))), rtol=0, atol=1e-6)


def test_forward_parallel_matches_jax(params):
    pj, pt = params
    np.testing.assert_allclose(TR.forward_parallel(pt, CFG, IDS).numpy(),
                               np.asarray(JR.forward_parallel(pj, JCFG, jnp.asarray(IDS))), rtol=0, atol=FP32_ATOL)


def test_forward_recurrent_matches_jax(params):
    """Chunks of 5, 1 and 7: the logits and the carried state."""
    pj, pt = params
    sj, st = JR.init_state(JCFG, 1), TR.init_state(CFG, 1, pt)
    for a, b in ((0, 5), (5, 6), (6, 13)):
        lj, sj = JR.forward_recurrent(pj, JCFG, jnp.asarray(IDS[:, a:b]), sj)
        lt, st = TR.forward_recurrent(pt, CFG, IDS[:, a:b], st)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0, atol=FP32_ATOL)
        np.testing.assert_allclose(st.s.numpy(), np.asarray(sj.s), rtol=0, atol=FP32_ATOL)
        assert int(st.pos) == int(sj.pos) == b


@pytest.mark.parametrize("chunk", [1, 3])
def test_parallel_matches_recurrent(params, chunk):
    """The defining property of retention: the O(L^2) parallel form and the
    recurrent form, token by token and in chunks of 3, are one function."""
    _, pt = params
    par = TR.forward_parallel(pt, CFG, IDS)
    state, outs = TR.init_state(CFG, 1, pt), []
    for t in range(0, IDS.shape[1], chunk):
        lg, state = TR.forward_recurrent(pt, CFG, IDS[:, t : t + chunk], state)
        outs.append(lg)
    torch.testing.assert_close(torch.cat(outs, dim=1), par, rtol=FORMS_TOL, atol=FORMS_TOL)


@pytest.fixture(scope="module")
def trained(params):
    pj, pt = params
    texts = ["ababab", "ababab"]
    return JR.train_byte_lm(pj, JCFG, texts, steps=60, lr=3e-3), TR.train_byte_lm(pt, CFG, texts, steps=60, lr=3e-3)


def test_train_byte_lm_matches_jax(trained, params):
    """60 Adam steps on the JAX test's texts: each step's loss within
    LOSS_RTOL of JAX's, the loss below half its start, and the weights the
    caller passed left as they were."""
    (_, jl), (pt2, tl) = trained
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    assert tl[-1] < tl[0] * 0.5
    _, pt = params
    assert not torch.equal(pt2["lm_head"], pt["lm_head"]) and not pt["lm_head"].requires_grad


def test_generate_bytes_matches_jax(trained, params):
    (pj2, _), (pt2, _) = trained
    out = TR.generate_bytes(pt2, CFG, "abab", max_tokens=8)
    assert out == JR.generate_bytes(pj2, JCFG, "abab", max_tokens=8)
    assert "ab" in out
    pj, pt = params
    assert TR.generate_bytes(pt, CFG, "Hello", max_tokens=8) == JR.generate_bytes(pj, JCFG, "Hello", max_tokens=8)
