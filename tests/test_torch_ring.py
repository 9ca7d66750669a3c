"""Ring attention and the sequence-parallel prefill of the port
(``parallel/ring_attention.py``, ``models/phi3.py:prefill_ring``,
``LM(sp_mesh=)``) on the CPU against the JAX package, in one spawned gloo
world of four ranks on the ``data`` axis (tests/test_ring_attention.py's
ring), plus a ring of one in this process.

Inputs are drawn with numpy from a seed and carried into both packages.
The ring attends to the chunk's fresh k and v whatever the cache, as the
JAX ``prefill_ring`` does (the plain int4 prefill attends to the
dequantized cache), so its int4 run gives the dense ring's logits and
quantizes the dense ring's keys.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from phi_3_vision_mlx_tpu.core.config import preset as jax_preset  # noqa: E402
from phi_3_vision_mlx_tpu.engine.engine import LM as JaxLM, generate_text as jax_generate  # noqa: E402
from phi_3_vision_mlx_tpu.models import phi3 as JM  # noqa: E402
from phi_3_vision_mlx_tpu.models.preprocess import Phi3Processor as JaxProcessor  # noqa: E402
from phi_3_vision_mlx_tpu.models.tokenizer import ByteTokenizer as JaxByteTokenizer  # noqa: E402
from phi_3_vision_mlx_tpu.parallel.mesh import make_mesh as jax_make_mesh  # noqa: E402
from phi_3_vision_mlx_tpu.parallel.ring_attention import make_ring_attention as jax_ring  # noqa: E402
from phi_3_vision_mlx_tpu_torch.core.config import preset  # noqa: E402
from phi_3_vision_mlx_tpu_torch.core.convert import from_jax_kv_cache, from_numpy_params  # noqa: E402
from phi_3_vision_mlx_tpu_torch.engine import state as TS  # noqa: E402
from phi_3_vision_mlx_tpu_torch.models import phi3 as TM  # noqa: E402
from phi_3_vision_mlx_tpu_torch.ops.attention import causal_valid_mask, masked_attention  # noqa: E402
from phi_3_vision_mlx_tpu_torch.parallel import mesh as PM  # noqa: E402
from phi_3_vision_mlx_tpu_torch.parallel.dryrun import ReplayEntries  # noqa: E402
from phi_3_vision_mlx_tpu_torch.parallel.ring_attention import NEG_INF, make_ring_attention  # noqa: E402
from test_torch_model import one_thread  # noqa: E402,F401
from torch_world import numpy_params, ring_suite  # noqa: E402

RING_TOL = 2e-4  # tests/test_ring_attention.py:14 (rtol and atol)
# fp32 logits of O(1-10), the port against JAX (tests/test_torch_model.py:
# FP32_ATOL); the ring's online softmax sums in another order.
LOGIT_ATOL = 1e-4
PROMPT = "Tell me about lighthouses and their keepers."
FORCED_STEPS = 4


def _attention_cases():
    """(q, k, v, valid) at kvh 8 and 4 (b 2, h 8, l 64, d 32; the first 5
    positions pads), f32, as tests/test_ring_attention.py draws them."""
    rng = np.random.default_rng(0)
    cases = []
    for kvh in (8, 4):
        q = rng.standard_normal((2, 8, 64, 32)).astype(np.float32)
        k = rng.standard_normal((2, kvh, 64, 32)).astype(np.float32)
        v = rng.standard_normal((2, kvh, 64, 32)).astype(np.float32)
        valid = np.ones((2, 64), bool)
        valid[:, :5] = False
        cases.append((q, k, v, valid))
    return cases


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.fixture(scope="module")
def world():
    cases = _attention_cases()
    jmesh = jax_make_mesh(data=4, model=1)
    jax_out = [np.asarray(jax_ring(jmesh, seq_axis="data")(*map(jnp.asarray, c))) for c in cases]

    cfg, jcfg = preset("tiny"), jax_preset("tiny")  # fp32, 4 heads over 2 KV heads
    tree = numpy_params(cfg, seed=0)
    ids = np.random.default_rng(0).integers(2, cfg.vocab_size, (1, 32))
    params = _jax(tree)
    res = JM.prefill(params, jcfg, jnp.asarray(ids), max_tokens=8)
    jax_logits, state, forced = [np.asarray(res.logits)], res.state, []
    for _ in range(FORCED_STEPS):
        forced.append(int(np.asarray(res.logits[0, -1]).argmax()))
        res = JM.decode_forward(params, jcfg, state, jnp.asarray([[forced[-1]]], jnp.int32))
        jax_logits.append(np.asarray(res.logits))
        state = res.state

    # JAX's int4 ring prefill and its greedy decode: each forward's logits,
    # and every entry the run wrote, for the port's ranks to replay.
    qcfg = jcfg.replace(use_quantized_cache=True)
    res = JM.prefill_ring(params, qcfg, jnp.asarray(ids), jmesh, max_tokens=8)
    jax_int4, state, forced_int4 = [np.asarray(res.logits)], res.state, []
    for _ in range(FORCED_STEPS):
        forced_int4.append(int(np.asarray(res.logits[0, -1]).argmax()))
        res = JM.decode_forward(params, qcfg, state, jnp.asarray([[forced_int4[-1]]], jnp.int32))
        jax_int4.append(np.asarray(res.logits))
        state = res.state
    entries = from_jax_kv_cache(np.asarray(state.kv.k), np.asarray(state.kv.k_scales.astype(jnp.float32)),
                                qcfg.kv_quant.bits)

    # The port's plain int4 prefill: the entries the ring's should be.
    with torch.no_grad():
        plain = TM.prefill(from_numpy_params(tree, cfg), cfg.replace(use_quantized_cache=True),
                           torch.as_tensor(ids), max_tokens=8)

    lm_cfg, jlm_cfg = preset("tiny", vocab_size=32064), jax_preset("tiny", vocab_size=32064)
    lm_tree = numpy_params(lm_cfg, seed=1)
    jax_text = jax_generate(JaxLM(jlm_cfg, _jax(lm_tree)), JaxProcessor(tokenizer=JaxByteTokenizer()), PROMPT,
                            max_tokens=6, verbose=False, stream=False, mute=True)
    ranks = PM.run_world(ring_suite, 4, cases, tree, cfg, ids, forced, (forced_int4, entries), lm_tree, lm_cfg,
                         PROMPT, timeout=240.0)
    return dict(cases=cases, jax_out=jax_out, jax_logits=jax_logits, jax_int4=jax_int4, plain=plain,
                jax_text=jax_text, ranks=ranks)


@pytest.mark.parametrize("case", [0, 1], ids=["kvh8", "kvh4"])
def test_ring_self_attention_matches_jax(world, case):
    """Each rank's 16 queries against JAX ``make_ring_attention`` over the
    same 4-device ring (GQA heads at kvh 4, five pad keys)."""
    want = world["jax_out"][case]
    for r, out in enumerate(world["ranks"]):
        np.testing.assert_allclose(out["attention"][case], want[:, :, r * 16 : (r + 1) * 16], rtol=RING_TOL,
                                   atol=RING_TOL)


def test_prefill_ring_and_its_decode_match_jax(world):
    """``prefill_ring`` over 4 ranks gives every rank the logits of the
    whole prompt, and the gathered cache decodes on: four steps, forced
    with JAX's greedy tokens, within LOGIT_ATOL of JAX's prefill and
    decode on one device."""
    for out in world["ranks"]:
        got = out["prefill_ring"]
        assert len(got) == FORCED_STEPS + 1 and got[0].shape == world["jax_logits"][0].shape
        for a, b in zip(got, world["jax_logits"]):
            np.testing.assert_allclose(a, b, rtol=0, atol=LOGIT_ATOL)


def test_prefill_ring_int4_gathers_the_quantized_cache(world):
    """With the int4 cache, each rank quantizes its columns and the ranks
    gather them: every rank holds the quantization of the dense ring's k and
    v over the whole prompt, bit for bit (the ring attends to fresh k and v
    whatever the cache, so both runs compute the same keys); layer 0's
    entries are the plain int4 prefill's; and the last logits are the dense
    ring's (the lm_head of one row against that of the whole prompt: f32
    rounding, within 1e-5)."""
    plain, l = world["plain"], 32
    kvq = plain.state.kv_quant
    for out in world["ranks"]:
        logits, payload, scales = out["prefill_ring_int4"]
        np.testing.assert_allclose(logits[:, -1], out["prefill_ring"][0][:, -1], rtol=0, atol=1e-5)
        k, v = (torch.as_tensor(t[:, :, :, :l]) for t in out["ring_kv"])
        want_p, want_s = TS.quantize_chunk(k, v, kvq)
        assert np.array_equal(payload[:, :, :, :l], want_p.numpy())
        assert np.array_equal(scales[:, :, :, :l], want_s.float().numpy())
        assert not payload[:, :, :, l:].any() and not scales[:, :, :, l:].any()
        assert np.array_equal(payload[0], plain.state.k[0].numpy())


def test_prefill_ring_int4_and_its_decode_match_jax(world):
    """``prefill_ring`` over 4 ranks with the int4 cache, then four steps
    forced with the greedy tokens of JAX's int4 ``prefill_ring`` and
    decode, every forward's logits within LOGIT_ATOL of JAX's.  Each rank
    writes JAX's entries in place of its own (``ReplayEntries``: a 1-ulp
    difference in k can round to the neighbouring level and move the
    logits by 0.1); its own entries differ by at most one level, at no
    more than MAX_FLIP_SHARE of the values."""
    for out in world["ranks"]:
        got = out["ring_int4_decode"]
        assert len(got) == FORCED_STEPS + 1 and got[0].shape == world["jax_int4"][0].shape
        for a, b in zip(got, world["jax_int4"]):
            np.testing.assert_allclose(a, b, rtol=0, atol=LOGIT_ATOL)
        values, flips, max_step = out["ring_int4_replay"]
        assert values > 0 and max_step <= 1 and flips <= ReplayEntries.MAX_FLIP_SHARE * values


def test_lm_sp_mesh_generates_the_jax_string(world):
    """``generate_text`` through ``LM(sp_mesh=make_mesh(data=4))``: the
    prompt prefills through the ring once and every rank decodes JAX's
    string (tests/test_ring_attention.py:69)."""
    for out in world["ranks"]:
        assert out["ring_prefills"] == 1
        assert out["text"] == world["jax_text"] and len(out["text"]) > 0


@pytest.fixture
def world_of_one():
    PM.distributed_init(device="cpu")
    yield PM.make_mesh(data=1)
    torch.distributed.destroy_process_group()


def test_ring_of_one_is_causal_attention(world_of_one):
    """A ring of one sends nothing and is the plain masked attention; a
    query that sees no key averages every value, as the JAX merge does."""
    q, k, v, valid = (torch.as_tensor(t) for t in _attention_cases()[1])
    out = make_ring_attention(world_of_one)(q, k, v, valid)
    kk, vv = k.repeat_interleave(2, dim=1), v.repeat_interleave(2, dim=1)
    ref = masked_attention(q, kk, vv, causal_valid_mask(valid, torch.arange(64)), 32 ** -0.5)
    torch.testing.assert_close(out, ref, rtol=RING_TOL, atol=RING_TOL)
    torch.testing.assert_close(out[:, :, 0], vv.mean(dim=2), rtol=RING_TOL, atol=RING_TOL)
    assert NEG_INF == -0.7 * float(np.finfo(np.float32).max)


def test_lm_without_sp_mesh_keeps_the_plain_route(world_of_one, monkeypatch):
    """No mesh, or a bucket that does not split over the ring: the plain
    prefill, no ring."""
    from phi_3_vision_mlx_tpu_torch.engine import engine as TE
    from phi_3_vision_mlx_tpu_torch.models.preprocess import Phi3Processor
    from phi_3_vision_mlx_tpu_torch.models.tokenizer import ByteTokenizer

    cfg = preset("tiny", vocab_size=32064)
    params = TM.init_params(cfg, torch.Generator().manual_seed(0))
    proc = Phi3Processor(tokenizer=ByteTokenizer())
    plain = TE.LM(cfg, params, device="cpu")
    ring = TE.LM(cfg, params, device="cpu", sp_mesh=world_of_one)
    kw = dict(max_tokens=4, verbose=False, stream=False, mute=True)
    assert TE.generate_text(ring, proc, PROMPT, **kw) == TE.generate_text(plain, proc, PROMPT, **kw)
    assert (plain.ring_prefills, ring.ring_prefills) == (0, 1)
    monkeypatch.setattr(TE, "axis_size", lambda mesh, axis: 3)  # 64 does not split over 3 ranks
    TE.generate_text(ring, proc, PROMPT, **kw)
    assert ring.ring_prefills == 1
