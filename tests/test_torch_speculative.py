"""The port's prompt-lookup speculation (``engine/speculative.py`` and the
slot engines' verify passes) against the JAX package's, on the CPU in fp32.

The contract: greedy speculation emits the vanilla greedy stream token for
token (acceptance is argmax-match), in the single-stream engine and in the
slot and paged engines, dense and int4 cache, text and image prompts, and
the same stream as the JAX package's speculation; the forced-reject
baseline (``spec_accept=False``, one token a pass through the same graph)
emits it too.  The sampling half (rejection-sampled verification) is held
to the JAX functions given the JAX package's own noise, and its first
token's distribution to vanilla sampling.  With the int4 cache the port
writes the JAX package's quantized entries where its own agree with them
(``ReplayJaxCacheSpec``, ``ReplayJaxPoolSpec``; see
tests/test_torch_model.py:ReplayJaxCache for why): a verify pass also
writes the columns of drafts it rejects, which the next pass overwrites.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_batching import ReplayJaxPool  # noqa: E402
from test_torch_model import ReplayJaxCache, _jax_decode, make_checkpoint  # noqa: E402

from phi_3_vision_mlx_tpu.api import _load as jax_load  # noqa: E402
from phi_3_vision_mlx_tpu.engine import engine as JE  # noqa: E402
from phi_3_vision_mlx_tpu.engine import speculative as JS  # noqa: E402
from phi_3_vision_mlx_tpu.engine.batching import BatchEngine as JBatch  # noqa: E402
from phi_3_vision_mlx_tpu.engine.paging import PagedBatchEngine as JPaged  # noqa: E402
from phi_3_vision_mlx_tpu_torch.api import _load as torch_load  # noqa: E402
from phi_3_vision_mlx_tpu_torch.core.convert import from_jax_paged_pool, from_numpy_params  # noqa: E402
from phi_3_vision_mlx_tpu_torch.engine import engine as TE  # noqa: E402
from phi_3_vision_mlx_tpu_torch.engine import paging as TP  # noqa: E402
from phi_3_vision_mlx_tpu_torch.engine import speculative as TS  # noqa: E402
from phi_3_vision_mlx_tpu_torch.engine import state as TST  # noqa: E402
from phi_3_vision_mlx_tpu_torch.engine.batching import BatchEngine as TBatch  # noqa: E402
from phi_3_vision_mlx_tpu_torch.engine.paging import PagedBatchEngine as TPaged  # noqa: E402
from phi_3_vision_mlx_tpu_torch.engine.rng import NoiseGen  # noqa: E402
from phi_3_vision_mlx_tpu_torch.models import phi3 as TM  # noqa: E402

@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the many small sorts and noise draws of these
    tests would otherwise keep every thread of the suite's parallel workers
    spinning."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REPEAT = "<|user|>\nThe cat sat on the mat. The cat sat on the mat. The cat<|end|>\n<|assistant|>\n"
PLAIN = "<|user|>\nQ: summarize the following paragraph in one word.<|end|>\n<|assistant|>\n"
SERVE = ["Tell me about the sea.", "tick tock tick tock tick tock", "Write a poem in winter."]


def t(x, dtype=torch.long):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


# --- draft proposal (tests/test_speculative.py:38-92) --------------------------


def propose_both(buf, valid, tok, off, k):
    want = np.asarray(JS.propose_drafts(jnp.asarray(buf, jnp.int32), jnp.asarray(valid),
                                        jnp.asarray(tok, jnp.int32), jnp.asarray(off, jnp.int32), k))
    got = TS.propose_drafts(t(buf), t(valid, torch.bool), t(tok), t(off).reshape(-1), k).numpy()
    np.testing.assert_array_equal(got, want)
    return got


def test_propose_continues_most_recent_ngram():
    buf = [[5, 6, 7, 8, 5, 6, 9, 1, 0, 0, 0, 0]]
    assert propose_both(buf, np.ones((1, 12), bool), [[6]], 8, 3).tolist() == [[9, 1, 1]]


def test_propose_prefers_longer_ngram():
    buf = [[7, 7, 4, 8, 4, 9, 7, 7, 0, 0, 0, 0]]
    assert propose_both(buf, np.ones((1, 12), bool), [[4]], 8, 2)[0, 0] == 8


def test_propose_excludes_pad_and_uncommitted():
    buf = [[9, 9, 9, 1, 2, 3, 9, 5, 5, 5, 5, 5]]
    valid = np.concatenate([np.zeros((1, 3), bool), np.ones((1, 9), bool)], axis=1)
    assert not np.any(propose_both(buf, valid, [[9]], 7, 2) == 5)


@pytest.mark.parametrize("k", [1, 3, 7, 32])
def test_propose_matches_jax_on_random_histories(k):
    """Per-row offsets (the slot engines), left pads, negative placeholder
    ids (vision prompts), offsets 0 and 1, a small alphabet so n-grams
    repeat."""
    rng = np.random.default_rng(k)
    b, w = 6, 96
    buf = rng.integers(0, 5, (b, w))
    buf[1, 10:20] = -1
    valid = np.ones((b, w), bool)
    valid[2, :12] = False
    off = np.array([0, 1, 40, 95, 60, 96])
    tok = rng.integers(0, 5, (b, 1))
    propose_both(buf, valid, tok, off, k)
    propose_both(buf[:1], valid[:1], tok[:1], off[3], k)  # the single stream's scalar offset


# --- verification given the JAX package's noise -------------------------------


def jax_noise(key, b, k, v):
    kd, kr, kb = jax.random.split(key, 3)
    return tuple(torch.from_numpy(np.array(x)) for x in (
        jax.random.uniform(kd, (b, k)), jax.random.gumbel(kr, (b, k, v)), jax.random.gumbel(kb, (b, v))))


def verify_case(seed, b=6, k=5, v=60):
    """Logits whose drafts are often likely (so acceptance runs deep)."""
    rng = np.random.default_rng(seed)
    logits = (2 * rng.standard_normal((b, k + 1, v))).astype(np.float32)
    draft = rng.integers(0, v, (b, k))
    for r in range(b):
        for i in range(k):
            if rng.random() < 0.7:
                logits[r, i, draft[r, i]] += 4.0
    return logits, draft


@pytest.mark.parametrize("sampler", [(0.9, 0.95, 0, 0.0), (1.0, 1.0, 0, 0.0), (0.7, 0.8, 20, 0.05)])
def test_verify_sampled_matches_jax(sampler):
    for i in range(4):
        logits, draft = verify_case(i)
        key = jax.random.PRNGKey(i)
        w_out, w_n = JS.verify_sampled(jnp.asarray(logits), jnp.asarray(draft, jnp.int32), key, *sampler)
        g_out, g_n = TS.verify_sampled(torch.from_numpy(logits), t(draft),
                                       jax_noise(key, *draft.shape, logits.shape[-1]), *sampler)
        np.testing.assert_array_equal(g_out.numpy(), np.asarray(w_out))
        np.testing.assert_array_equal(g_n.numpy(), np.asarray(w_n))


def test_verify_mixed_rows_matches_jax():
    temps = np.array([0.0, 1.0, 0.8, 0.0, 1.3, 0.6], np.float32)
    top_ps = np.array([1.0, 0.9, 1.0, 0.5, 0.95, 0.7], np.float32)
    top_ks = np.array([0, 0, 10, 0, 3, 0], np.int64)
    min_ps = np.array([0.0, 0.0, 0.05, 0.0, 0.0, 0.1], np.float32)
    accepted = []
    for i in range(4):
        logits, draft = verify_case(10 + i)
        key = jax.random.PRNGKey(10 + i)
        w_out, w_acc = JS.verify_mixed_rows(jnp.asarray(logits), jnp.asarray(draft, jnp.int32), key,
                                            jnp.asarray(temps), jnp.asarray(top_ps),
                                            jnp.asarray(top_ks, jnp.int32), jnp.asarray(min_ps))
        g_out, g_acc = TS.verify_mixed_rows(torch.from_numpy(logits), t(draft),
                                            jax_noise(key, *draft.shape, logits.shape[-1]),
                                            *map(torch.from_numpy, (temps, top_ps, top_ks, min_ps)))
        np.testing.assert_array_equal(g_out.numpy(), np.asarray(w_out))
        np.testing.assert_array_equal(g_acc.numpy(), np.asarray(w_acc))
        accepted += g_acc.tolist()
    assert max(accepted) > 1 and min(accepted) == 0


def test_verify_sampled_first_token_matches_vanilla_distribution():
    """The first emitted token's distribution (accept, or resample the
    residual) is the filtered target's (tests/test_spec_sampling.py:31),
    drawn with the port's generator."""
    v, k, n = 12, 3, 8000
    logits = torch.from_numpy((2.0 * np.random.default_rng(0).standard_normal((1, k + 1, v))).astype(
        np.float32))
    draft = t([[3, 7, 1]])
    sampler = (0.9, 0.95, 0, 0.0)
    gen = NoiseGen(n, "cpu")
    gen.reset(range(n))
    out, _ = TS.verify_sampled(logits.expand(n, -1, -1), draft.expand(n, -1), TS.verify_noise(gen, k, v),
                               *sampler)
    p_spec = np.bincount(out[:, 0].numpy(), minlength=v) / n
    p_true = torch.softmax(TE.filter_sample_logits(logits[:, 0], *sampler), dim=-1)[0].numpy()
    se = np.sqrt(p_true * (1 - p_true) / n) + 1e-9
    assert np.all(np.abs(p_spec - p_true) < 5 * se), (np.abs(p_spec - p_true) / se).max()


# --- single stream --------------------------------------------------------------


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return make_checkpoint(tmp_path_factory.mktemp("ckpt"), "tiny")


@pytest.fixture(scope="module")
def pair(ckpt):
    return jax_load(ckpt), torch_load(ckpt, device="cpu")


def spec_env(monkeypatch, iters="8", k="7"):
    monkeypatch.setenv("PHI3V_TPU_SPEC_ITERS", iters)
    monkeypatch.setenv("PHI3V_TPU_SPEC_K", k)


def generate(lm, proc, prompt, spec, max_tokens=48, module=TE, **kw):
    return module.generate_text(lm, proc, prompt, max_tokens=max_tokens, verbose=False, stream=False,
                                mute=True, speculative=spec, **kw)


@pytest.mark.parametrize("prompt,max_tokens", [(REPEAT, 48), (PLAIN, 32)], ids=["repeat", "plain"])
def test_generate_speculative_matches_vanilla_and_jax(pair, monkeypatch, prompt, max_tokens):
    spec_env(monkeypatch)
    (jlm, jproc), (tlm, tproc) = pair
    vanilla = generate(tlm, tproc, prompt, False, max_tokens)
    spec = generate(tlm, tproc, prompt, True, max_tokens)
    assert spec == vanilla == generate(jlm, jproc, prompt, True, max_tokens, module=JE)
    stats = tlm._spec_stats
    assert stats["emitted"] >= stats["iters"] > 0 and stats["dead"] == 0
    assert stats["emitted"] == jlm._spec_stats["emitted"]


def test_api_generate_speculative_by_environment(ckpt, monkeypatch):
    from phi_3_vision_mlx_tpu_torch import api

    spec_env(monkeypatch)
    lm, proc = torch_load(ckpt, device="cpu")
    kw = dict(preload=(lm, proc), max_tokens=20, verbose=False, stream=False, mute=True)
    want = api.generate("The cat sat on the mat. The cat", **kw)
    monkeypatch.setenv("PHI3V_TPU_SPEC", "1")
    assert api.generate("The cat sat on the mat. The cat", **kw) == want
    assert lm._spec_stats["iters"] > 0


def test_speculative_window_tail_falls_back(pair, monkeypatch):
    """A window too short for a pass finishes through the vanilla steps."""
    spec_env(monkeypatch, iters="32")
    (jlm, jproc), (tlm, tproc) = pair
    prompt = "<|user|>\ntick tock tick tock tick<|end|>\n<|assistant|>\n"
    want = generate(jlm, jproc, prompt, True, 12, module=JE)
    assert generate(tlm, tproc, prompt, True, 12) == generate(tlm, tproc, prompt, False, 12) == want


class ReplayJaxCacheSpec(ReplayJaxCache):
    """``ReplayJaxCache`` for verify passes: positions whose own entries
    agree with the JAX run's (those of accepted tokens) take the JAX
    entries; the others are rejected drafts' columns, which the next pass
    overwrites before anything reads them, and keep their own."""

    def __init__(self, jax_state, bits):
        super().__init__(jax_state, bits)
        self.kept = 0

    def __call__(self, state, layer, pos, k_new, v_new):
        want_p, want_s = self.payload[layer, :, :, pos], self.scales[layer, :, :, pos]
        own_p, own_s = TST.quantize_chunk(k_new, v_new, state.kv_quant)
        levels = (self._levels(own_p).int() - self._levels(want_p).int()).abs()
        agree = (levels.amax(dim=(0, 1, 2, 4)) <= 1) & torch.isclose(
            own_s.float(), want_s.float(), rtol=2.0**-7, atol=1e-6).all(-1).all(0).all(0)
        self.kept += int((~agree).sum())
        self.values += int(levels[..., agree, :].numel())
        self.flips += int((levels[..., agree, :] > 0).sum())
        w = agree[None, None, :, None]
        state.k[layer, :, :, pos] = torch.where(w, want_p, own_p)
        state.k_scales[layer, :, :, pos] = torch.where(w, want_s, own_s)


def test_generate_speculative_int4_cache_matches_jax(ckpt, monkeypatch):
    """The int4 cache: the JAX package's entries replayed; speculation
    equals the port's and the JAX package's vanilla and speculative
    streams."""
    spec_env(monkeypatch)
    (jlm, jproc), (tlm, tproc) = (jax_load(ckpt, use_quantized_cache=True),
                                  torch_load(ckpt, device="cpu", use_quantized_cache=True))
    prompt = "<|user|>\nalpha beta gamma alpha beta gamma alpha beta<|end|>\n<|assistant|>\n"
    want = generate(jlm, jproc, prompt, False, 32, module=JE)
    assert generate(jlm, jproc, prompt, True, 32, module=JE) == want
    _, jstate = _jax_decode(jlm, jproc(prompt), 32)
    replay = ReplayJaxCacheSpec(jstate, 4)
    monkeypatch.setattr(TM, "update_layer_chunk", replay)
    assert generate(tlm, tproc, prompt, True, 32) == want
    assert tlm._spec_stats["iters"] > 0
    replay.check()


def test_speculation_accepts_on_a_looping_generation():
    """A vocab-512 random model loops: passes accept drafts (more than one
    token a pass) and the stream is the vanilla one and the JAX
    package's; with a budget of 5 the passes stop on the device (a dead
    pass commits nothing)."""
    from phi_3_vision_mlx_tpu.core.config import preset
    from phi_3_vision_mlx_tpu.models import phi3 as JM

    cfg = preset("tiny")
    jparams = JM.init_params(cfg, jax.random.PRNGKey(3))
    jlm = JE.LM(cfg, jparams)
    tlm = TE.LM(cfg, from_numpy_params(jax.tree_util.tree_map(np.asarray, jparams), cfg), device="cpu")
    di = {"input_ids": np.tile(np.array([[5, 6, 7, 8]], np.int32), (1, 4))}
    n_iters, k = 32, 7

    logits, state, l_pad, window = JE.run_prefill(jlm, dict(di), 360)
    tok = jnp.asarray(np.argmax(np.asarray(logits), -1).astype(np.int32)[:, None])
    buf = JS.init_token_buffer(np.pad(di["input_ids"], ((0, 0), (l_pad - 16, 0))), window)
    sfn = JS.spec_chunk_fn(jlm, window, n_iters, k)
    jax_stream = [int(tok[0, 0])]
    for _ in range(2):
        tok, state, buf, toks, _, _, n_emits = sfn(jlm.params, tok, state, buf,
                                                   jnp.asarray(360 - len(jax_stream), jnp.int32),
                                                   jax.random.PRNGKey(0))
        for it, m in enumerate(np.asarray(n_emits)):
            jax_stream += [int(x) for x in np.asarray(toks)[it, 0, : int(m)]]

    def port_run(chunks, left=None):
        dec, first = TE.prefill_decoder(tlm, dict(di), 360)
        spec = dec.spec_pass(k)
        spec.start(TE.pad_prompt_inputs(di, dec.state.offset)[0])
        stream, emits = [int(first[0, 0])], []
        for _ in range(chunks):
            toks, _, _, n_emit = spec.chunk(n_iters, 360 - len(stream) if left is None else left)
            dec.advance_mirror(int(n_emit.sum()))
            emits += n_emit[:, 0].tolist()
            for it in range(n_iters):
                stream += toks[it, 0, : int(n_emit[it, 0])].tolist()
        return stream, emits, dec

    stream, emits, _ = port_run(2)
    assert stream == jax_stream
    assert len(stream) - 1 > 2 * n_iters * 1.2
    vanilla, _ = TE.prefill_decoder(tlm, dict(di), 360)
    assert stream[1:] == vanilla.chunk(len(stream) - 1)[0][:, 0].tolist()
    _, emits, dec = port_run(1, left=5)
    assert 5 <= sum(emits) <= 5 + k and emits[-1] == 0
    assert int(dec.state.pos[0]) == dec.state.offset == l_pad + sum(emits)


def test_image_prompt_speculative_matches_vanilla(tmp_path, monkeypatch):
    """An image prompt on ``tiny_vision``: negative placeholder ids in the
    history never reach the drafts; the stream is the vanilla one and the
    JAX package's greedy one."""
    from test_torch_vision import images_for, load_pair, vision_checkpoint

    from phi_3_vision_mlx_tpu import api as JAPI
    from phi_3_vision_mlx_tpu_torch import api as TAPI

    spec_env(monkeypatch)
    (jlm, jproc), (tlm, tproc) = load_pair(vision_checkpoint(tmp_path, "tv"))
    kw = dict(max_tokens=12, verbose=False, stream=False, mute=True, images=images_for(1))
    want = JAPI.generate("What is shown in this image?", preload=(jlm, jproc), **kw)
    assert TAPI.generate("What is shown in this image?", preload=(tlm, tproc), speculative=True,
                         **kw) == want
    assert tlm._spec_stats["iters"] > 0


def test_sampled_speculation_is_seeded(pair, monkeypatch):
    spec_env(monkeypatch)
    _, (tlm, tproc) = pair
    kw = dict(sample=True, temperature=0.8, top_p=0.95, seed=3)
    a = generate(tlm, tproc, REPEAT, True, 24, **kw)
    assert a == generate(tlm, tproc, REPEAT, True, 24, **kw) and len(a) > 0
    assert tlm._spec_stats["emitted"] >= tlm._spec_stats["iters"] > 0


def test_spec_k_limits():
    with pytest.raises(ValueError, match=r"\[0, 32\]"):
        TS.check_spec_k(33, "cpu", kernel_rows=False)
    TS.check_spec_k(32, "cpu", kernel_rows=True)  # the CPU's plain paths take any row count
    with pytest.raises(ValueError, match="16-row limit"):
        TS.check_spec_k(16, "cuda", kernel_rows=True)
    TS.check_spec_k(15, "cuda", kernel_rows=True)
    TS.check_spec_k(32, "cuda", kernel_rows=False)  # the slot engine's plain attention


# --- slot and paged engines (tests/test_spec_serving.py) -----------------------


@pytest.fixture(scope="module")
def engines(ckpt):
    jlm, jproc = jax_load(ckpt)
    tree = jax.tree_util.tree_map(np.asarray, jlm.params)
    tlm = TE.LM(jlm.cfg, from_numpy_params(tree, jlm.cfg), device="cpu")
    return (jlm, jproc), (tlm, torch_load(ckpt, device="cpu")[1])


def run(eng, prompts, max_tokens=14, n_steps=2, stagger=False, **submit_kw):
    rids = []
    if stagger:
        rids.append(eng.submit(prompts[0], max_tokens=max_tokens, **submit_kw))
        eng.step(n_steps)
        prompts = prompts[1:]
    rids += [eng.submit(p, max_tokens=max_tokens, **submit_kw) for p in prompts]
    for _ in range(300):
        if not eng.pending():
            break
        eng.step(n_steps)
    assert not eng.pending()
    return [eng.tokens(r) for r in rids]


def make(pair_, paged, **kw):
    lm, proc = pair_
    if paged:
        return (JPaged if isinstance(lm, JE.LM) else TPaged)(lm, proc, page_size=32, **kw)
    return (JBatch if isinstance(lm, JE.LM) else TBatch)(lm, proc, **kw)


@pytest.mark.parametrize("k", [2, 7])
@pytest.mark.parametrize("paged", [False, True], ids=["slots", "paged"])
def test_engine_speculation_matches_jax(engines, paged, k):
    jpair, tpair = engines
    want = run(make(jpair, paged, slots=3, window=128, spec_k=k), SERVE)
    eng = make(tpair, paged, slots=3, window=128, spec_k=k)
    assert run(eng, SERVE) == want == run(make(tpair, paged, slots=3, window=128), SERVE)
    assert run(make(tpair, paged, slots=3, window=128, spec_k=k, spec_accept=False), SERVE) == want
    assert eng.spec_stats["emitted"] >= eng.spec_stats["passes"] > 0
    if paged:
        assert len(eng._free_pages) == eng.pool_pages


@pytest.mark.parametrize("paged", [False, True], ids=["slots", "paged"])
def test_engine_speculation_staggered_and_window_tail(engines, paged):
    """A request admitted mid-decode, and a slot whose window is too short
    for a whole pass (forced-reject rows inside the pass), keep the JAX
    package's streams."""
    jpair, tpair = engines
    for kw in (dict(stagger=True), dict(max_tokens=80)):
        prompts = SERVE[:2] if kw.get("stagger") else SERVE[:1]
        slots = len(prompts)
        want = run(make(jpair, paged, slots=slots, window=128, spec_k=7), prompts, **kw)
        eng = make(tpair, paged, slots=slots, window=128, spec_k=7)
        assert run(eng, prompts, **kw) == want
        assert sorted(eng.free) == list(range(slots))


def test_paged_speculation_preempts_and_resumes(engines):
    """Speculation on an undersized pool: the worst-case reservation
    preempts, every request completes with the JAX package's stream."""
    jpair, tpair = engines
    kw = dict(slots=2, window=128, pool_pages=5, spec_k=3)
    want = run(make(jpair, True, **kw), SERVE[:2], max_tokens=40, n_steps=1)
    eng = make(tpair, True, **kw)
    assert run(eng, SERVE[:2], max_tokens=40, n_steps=1) == want
    assert eng.preemptions > 0 and len(eng._free_pages) == eng.pool_pages


def test_engine_forced_reject_sampled_rows(engines):
    """``spec_accept=False`` with a sampled row: every pass commits one
    token a slot; the greedy row is the JAX package's greedy stream."""
    jpair, tpair = engines
    want = run(make(jpair, False, slots=1, window=128), SERVE[:1], max_tokens=10)[0]
    eng = make(tpair, False, slots=2, window=128, spec_k=5, spec_accept=False, seed=11)
    rg = eng.submit(SERVE[0], max_tokens=10)
    rs = eng.submit(SERVE[1], max_tokens=10, temperature=0.9, top_p=0.9)
    while eng.pending():
        eng.step(2)
    assert eng.tokens(rg) == want and len(eng.tokens(rs)) == 10
    assert eng.spec_stats["emitted"] == eng.spec_stats["passes"]


def test_engine_speculation_accepts_on_a_looping_generation():
    """The slot engine on a small-vocabulary random model (the byte
    tokenizer's ids fit): more than one token a pass a slot, the vanilla
    streams."""
    from phi_3_vision_mlx_tpu.core.config import preset
    from phi_3_vision_mlx_tpu.models import phi3 as JM
    from phi_3_vision_mlx_tpu_torch.models.preprocess import Phi3Processor
    from phi_3_vision_mlx_tpu_torch.models.tokenizer import ByteTokenizer

    cfg = preset("tiny").replace(vocab_size=1280)
    jparams = JM.init_params(cfg, jax.random.PRNGKey(5))
    tlm = TE.LM(cfg, from_numpy_params(jax.tree_util.tree_map(np.asarray, jparams), cfg), device="cpu")
    proc = Phi3Processor(tokenizer=ByteTokenizer())
    base = run(TBatch(tlm, proc, slots=2, window=256), ["abab", "cdcd"], max_tokens=120, n_steps=8)
    eng = TBatch(tlm, proc, slots=2, window=256, spec_k=7)
    assert run(eng, ["abab", "cdcd"], max_tokens=120, n_steps=8) == base
    assert eng.spec_stats["emitted"] / eng.spec_stats["passes"] > 1.2, eng.spec_stats


class ReplayJaxPoolSpec(ReplayJaxPool):
    """``ReplayJaxPool`` for a verify pass's (S, K + 1) writes; both engines
    run one pass a step in lockstep, so the JAX pool after the pass holds
    every column the pass wrote."""

    def __call__(self, st, layer, pid, row, k, v):
        if pid.dim() == 1:
            return super().__call__(st, layer, pid, row, k, v)
        own_p, own_s = (x.transpose(1, 2) for x in TST.quantize_chunk(k, v, st.kv_quant))
        want_p, want_s = (x[layer, pid, :, row] for x in self.snap)
        live = pid != st.k.shape[1] - 1
        step = (torch.stack([own_p & 15, own_p >> 4]).int()
                - torch.stack([want_p & 15, want_p >> 4]).int()).abs()[:, live]
        self.values += step.numel()
        self.flips += int((step > 0).sum())
        self.max_step = max(self.max_step, int(step.max()))
        torch.testing.assert_close(own_s[live].float(), want_s[live].float(), rtol=2.0**-7, atol=1e-6)
        w = live[:, :, None, None]
        st.k[layer, pid, :, row] = torch.where(w, want_p, own_p)
        st.k_scales[layer, pid, :, row] = torch.where(w, want_s, own_s)


def test_paged_int4_speculation_replays_jax(engines, monkeypatch):
    """The int4 pool (K7's layout) with spec_k = 2: both engines in
    lockstep, one pass a step; the port's prefills replay the JAX
    prefills' entries and its passes the JAX pool's, so the streams must
    be identical."""
    (jlm, jproc), (tlm, tproc) = engines
    jlm = JE.LM(jlm.cfg.replace(use_quantized_cache=True), jlm.params)
    tlm = TE.LM(tlm.cfg.replace(use_quantized_cache=True), tlm.params, device="cpu")
    jeng = JPaged(jlm, jproc, slots=2, window=128, page_size=64, spec_k=2)
    teng = TPaged(tlm, tproc, slots=2, window=128, page_size=64, spec_k=2)
    writer = ReplayJaxPoolSpec()
    monkeypatch.setattr(TP, "write_fresh", writer)
    prefills, jr, tr = [], [], []
    for step in range(40):
        if step in (0, 3):
            prompt = SERVE[0] if step == 0 else SERVE[1]
            jp = jeng.prepare(prompt, max_tokens=16)
            prefills.append(ReplayJaxCache(jp.src_state, 4))
            monkeypatch.setattr(TM, "update_layer_chunk", prefills[-1])
            tp = teng.prepare(prompt, max_tokens=16)
            jr.append(jeng.admit(jp))
            tr.append(teng.admit(tp))
        if not jeng.pending():
            break
        jeng.step(1)
        writer.snap = from_jax_paged_pool(np.asarray(jeng.state.pool_k),
                                          np.asarray(jeng.state.pool_v.astype(jnp.float32)),
                                          quantized=True)
        teng.step(1)
    assert not jeng.pending() and not teng.pending()
    assert [teng.tokens(r) for r in tr] == [jeng.tokens(r) for r in jr]
    writer.check()
    for replay in prefills:
        replay.check()
