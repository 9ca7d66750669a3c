"""The port's sampling (``engine/engine.py``'s filters and draws, the noise
generator ``engine/rng.py``) against the JAX package's, on the CPU in fp32.

``jax.random`` and the port's generator give other numbers from one seed,
so the functions take their noise as an argument: the tests draw the JAX
package's own Gumbel noise from its key (``jax.random.categorical(key, x)``
is ``argmax(x + jax.random.gumbel(key, x.shape))``) and require the same
tokens.  The nucleus filter sums sorted probabilities; torch's and XLA's
cumulative sums may round apart where the mass before a token lies within
1e-6 of ``top_p``, so such rows are left out of the comparisons and
counted.  The engines are held to the JAX package where they must be
exact: ``top_k = 1`` is greedy, and a greedy request beside a sampled one
keeps the JAX engines' greedy stream.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy import stats

torch = pytest.importorskip("torch")

from test_torch_batching import PROMPTS  # noqa: E402
from test_torch_model import PROMPT, make_checkpoint  # noqa: E402
from test_torch_model import one_thread  # noqa: E402,F401  (autouse: one torch thread)

from phi_3_vision_mlx_tpu.api import _load as jax_load  # noqa: E402
from phi_3_vision_mlx_tpu.engine import engine as JE  # noqa: E402
from phi_3_vision_mlx_tpu.engine.batching import BatchEngine as JBatch  # noqa: E402
from phi_3_vision_mlx_tpu.engine.paging import PagedBatchEngine as JPaged  # noqa: E402
from phi_3_vision_mlx_tpu_torch.api import _load as torch_load  # noqa: E402
from phi_3_vision_mlx_tpu_torch.engine import engine as TE  # noqa: E402
from phi_3_vision_mlx_tpu_torch.engine import graphs as TG  # noqa: E402
from phi_3_vision_mlx_tpu_torch.engine import rng as TR  # noqa: E402
from phi_3_vision_mlx_tpu_torch.engine.batching import BatchEngine as TBatch  # noqa: E402
from phi_3_vision_mlx_tpu_torch.engine.paging import PagedBatchEngine as TPaged  # noqa: E402

V = 777
NEAR = 1e-6  # cumulative-mass distance to top_p below which the two sums may disagree
# (temperature, top_p, top_k, min_p): each filter alone and together, top_p
# <= 0 (top-1 only), top_k beyond V, min_p = 0, and all filters off.
KNOBS = [(1.0, 0.9, 0, 0.0), (0.7, 1.0, 50, 0.0), (1.3, 0.5, 10, 0.05), (0.5, 0.0, 0, 0.0),
         (1.0, 1.0, V + 5, 0.0), (0.8, 0.95, 0, 0.1), (1.0, 1.0, 0, 0.0), (1e-3, 0.9, 3, 0.2),
         (0.9, 0.3, 1, 0.0), (2.0, 0.99, 100, 0.01)]


def logits_of(shape, seed=0):
    return (3 * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def near_rows(x, temps, top_ps):
    """Rows (leading index) whose nucleus decision is within NEAR of a tie."""
    scaled = x / np.maximum(temps, 1e-6).reshape(-1, *([1] * (x.ndim - 1)))
    desc = -np.sort(-scaled, axis=-1)
    p = np.exp(desc - desc.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    # The top token's preceding mass is 0 in both sums, exactly.
    gap = np.abs(np.cumsum(p, -1) - p - top_ps.reshape(-1, *([1] * (x.ndim - 1))))[..., 1:]
    return gap.reshape(x.shape[0], -1).min(-1) < NEAR


def rows_knobs():
    t, p, k, m = (np.asarray(c) for c in zip(*KNOBS))
    return t.astype(np.float32), p.astype(np.float32), k.astype(np.int64), m.astype(np.float32)


def check_rows(want, got, near):
    """Rows equal but for near ties, which must be few."""
    assert near.sum() <= len(near) // 3, near
    for r in np.flatnonzero(~near):
        np.testing.assert_array_equal(got[r], want[r])


@pytest.mark.parametrize("knobs", KNOBS)
@pytest.mark.parametrize("shape", [(6, V), (3, 4, V)], ids=["BV", "BLV"])
def test_filter_keeps_the_jax_set(knobs, shape):
    x = logits_of(shape)
    want = np.asarray(JE.filter_sample_logits(jnp.asarray(x), *knobs))
    got = TE.filter_sample_logits(torch.from_numpy(x), *knobs).numpy()
    near = near_rows(x, np.full(shape[0], knobs[0]), np.full(shape[0], knobs[1] if knobs[1] < 1
                                                              else np.inf))
    check_rows(np.isfinite(want), np.isfinite(got), near)
    kept = np.isfinite(want) & np.isfinite(got)
    np.testing.assert_allclose(got[kept], want[kept], rtol=1e-6, atol=0)


@pytest.mark.parametrize("shape", [(len(KNOBS), V), (len(KNOBS), 3, V)], ids=["BV", "BLV"])
def test_filter_rows_keeps_the_jax_set(shape):
    x = logits_of(shape, seed=1)
    t, p, k, m = rows_knobs()
    want = np.asarray(JE.filter_sample_logits_rows(jnp.asarray(x), jnp.asarray(t), jnp.asarray(p),
                                                   jnp.asarray(k, jnp.int32), jnp.asarray(m)))
    got = TE.filter_sample_logits_rows(torch.from_numpy(x), *map(torch.from_numpy, (t, p, k, m))).numpy()
    check_rows(np.isfinite(want), np.isfinite(got), near_rows(x, t, p))


@pytest.mark.parametrize("knobs", KNOBS)
def test_sample_token_draws_the_jax_token(knobs):
    """Given the JAX package's Gumbel noise for its key, the same tokens."""
    for i in range(3):
        x = logits_of((8, V), seed=10 + i)
        key = jax.random.PRNGKey(i)
        want = np.asarray(JE.sample_token(jnp.asarray(x), key, *knobs))
        gumbel = torch.from_numpy(np.array(jax.random.gumbel(key, x.shape)))
        got = TE.sample_token(torch.from_numpy(x), gumbel, *knobs).numpy()
        p = knobs[1] if knobs[1] < 1 else np.inf
        check_rows(want, got, near_rows(x, np.full(8, knobs[0]), np.full(8, p)))


def test_sample_token_rows_draws_the_jax_tokens():
    """Per-row knobs (greedy rows among them) with the JAX noise."""
    t, p, k, m = rows_knobs()
    t[[0, 3]] = 0.0  # exact argmax rows
    for i in range(4):
        x = logits_of((len(KNOBS), V), seed=20 + i)
        key = jax.random.PRNGKey(100 + i)
        want = np.asarray(JE.sample_token_rows(jnp.asarray(x), key, jnp.asarray(t), jnp.asarray(p),
                                               jnp.asarray(k, jnp.int32), jnp.asarray(m)))
        gumbel = torch.from_numpy(np.array(jax.random.gumbel(key, x.shape)))
        got = TE.sample_token_rows(torch.from_numpy(x), gumbel,
                                   *map(torch.from_numpy, (t, p, k, m))).numpy()
        check_rows(want, got, near_rows(x, t, p) & (t > 0))
        np.testing.assert_array_equal(got[t <= 0], x[t <= 0].argmax(-1))


@pytest.mark.parametrize("stream", [TR.SAMPLE, TR.ACCEPT, TR.RESAMPLE])
def test_generator_uniforms_pass_chi_square(stream):
    """2**16 uniforms a row (three seeds, two counters) in 256 bins: the
    chi-square p-value above 1e-3; the Gumbel transform's mean and spread
    are the standard Gumbel's."""
    gen = TR.NoiseGen(3, "cpu")
    gen.reset([0, 7, -(2**40) + 3])
    for _ in range(2):
        u = gen.uniform(stream, (1 << 16,)).numpy()
        assert u.min() >= 0 and u.max() < 1
        for row in u:
            assert stats.chisquare(np.bincount((row * 256).astype(int), minlength=256)).pvalue > 1e-3
        g = gen.gumbel(stream, (1 << 16,)).numpy()
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g.mean(1), np.euler_gamma, atol=0.02)
        np.testing.assert_allclose(g.std(1), np.pi / np.sqrt(6), atol=0.02)
        gen.advance()


def test_generator_rows_depend_on_their_own_seed_only():
    """A row draws from its seed and counter alone (a request samples the
    same noise in any slot); streams and counters give other draws."""
    a, b = TR.NoiseGen(3, "cpu"), TR.NoiseGen(1, "cpu")
    a.reset([5, 9, 11])
    b.reset([9])
    assert torch.equal(a.bits(TR.SAMPLE, (64,))[1], b.bits(TR.SAMPLE, (64,))[0])
    assert not torch.equal(a.bits(TR.SAMPLE, (64,)), a.bits(TR.BONUS, (64,)))
    before = a.bits(TR.SAMPLE, (64,))
    a.advance()
    assert not torch.equal(before, a.bits(TR.SAMPLE, (64,)))
    a.reset_row(0, 5)
    a.counters[1:] = 0
    assert torch.equal(before, a.bits(TR.SAMPLE, (64,)))


class _Stub:
    def __init__(self):
        self.body = None

    def replay(self):
        self.body()


def test_generator_draws_equal_eager_and_under_a_stub_capture():
    """A step that draws and advances, captured (a stub whose capture runs
    nothing, as the card's does, after a warm-up step that ``save``
    undoes) and replayed, writes what the eager step wrote."""
    def run(graphs):
        gen = TR.NoiseGen(2, "cpu")
        gen.reset([3, 4])
        out = torch.zeros((5, 2, 16))
        index = torch.zeros((1,), dtype=torch.long)

        def step():
            out.index_copy_(0, index, gen.gumbel(TR.SAMPLE, (16,))[None])
            index.add_(1)
            gen.advance()

        g = TG.StepGraph(step, "cpu", False, save=(gen.counters, index))
        if graphs:
            g.graphs = True
            g.new_graph = _Stub
            touched = (gen.counters, index, out)

            @contextlib.contextmanager
            def capturing(graph):
                graph.body = step
                before = [t.clone() for t in touched]
                yield
                for t, b in zip(touched, before):
                    t.copy_(b)

            g.capturing = capturing
            g.warm_up = step
        for _ in range(5):
            g()
        return out

    assert torch.equal(run(False), run(True))


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return make_checkpoint(tmp_path_factory.mktemp("ckpt"), "tiny")


def test_generate_top_k_1_is_greedy_in_both_packages(ckpt):
    kw = dict(max_tokens=16, verbose=False, stream=False, mute=True)
    (jlm, jproc), (tlm, tproc) = jax_load(ckpt), torch_load(ckpt, device="cpu")
    greedy = JE.generate_text(jlm, jproc, PROMPT, **kw)
    assert JE.generate_text(jlm, jproc, PROMPT, sample=True, top_k=1, seed=3, **kw) == greedy
    assert TE.generate_text(tlm, tproc, PROMPT, **kw) == greedy
    assert TE.generate_text(tlm, tproc, PROMPT, sample=True, top_k=1, seed=3, **kw) == greedy
    assert TE.generate_text(tlm, tproc, PROMPT, sample=True, temperature=0.5, top_k=1, top_p=0.9,
                            min_p=0.1, seed=4, **kw) == greedy


def test_generate_sampled_is_seeded(ckpt):
    """The same seed twice gives the same text; another seed another one;
    a batch's rows draw apart."""
    tlm, tproc = torch_load(ckpt, device="cpu")
    kw = dict(max_tokens=24, verbose=False, stream=False, mute=True, sample=True, temperature=1.5)
    a = TE.generate_text(tlm, tproc, PROMPT, seed=1, **kw)
    assert a == TE.generate_text(tlm, tproc, PROMPT, seed=1, **kw)
    assert a != TE.generate_text(tlm, tproc, PROMPT, seed=2, **kw)
    rows = TE.generate_text(tlm, tproc, [PROMPT, PROMPT], seed=1, **kw)
    assert rows[0] != rows[1]


@pytest.mark.parametrize("paged", [False, True], ids=["slots", "paged"])
def test_greedy_request_beside_a_sampled_one_matches_jax(ckpt, paged):
    """A sampled and a greedy request share the slot engines (the sampled
    step's graph serves both): the greedy request's stream is the JAX
    engine's, and the sampled one completes."""
    (jlm, jproc), (tlm, tproc) = jax_load(ckpt), torch_load(ckpt, device="cpu")
    kw = dict(slots=2, window=256, **({"page_size": 32} if paged else {}))
    streams = []
    for eng in ((JPaged if paged else JBatch)(jlm, jproc, **kw),
                (TPaged if paged else TBatch)(tlm, tproc, **kw)):
        greedy = eng.submit(PROMPTS[0], max_tokens=20)
        sampled = eng.submit(PROMPTS[1], max_tokens=20, temperature=0.9, top_p=0.9, top_k=40)
        while eng.pending():
            eng.step(4)
        streams.append((eng.tokens(greedy), eng.tokens(sampled)))
    (jg, js), (tg, ts) = streams
    assert tg == jg and len(tg) == 20
    assert len(ts) > 0


def test_slot_engine_sampled_request_is_seeded(ckpt):
    """A request's seed fixes its stream whatever its slot and neighbours;
    without a seed the engine's seed and the request id choose one."""
    tlm, tproc = torch_load(ckpt, device="cpu")

    def run(order, **kw):
        eng = TBatch(tlm, tproc, slots=3, window=256)
        rids = [eng.submit(PROMPTS[i], max_tokens=12, temperature=1.2, seed=100 + i, **kw)
                for i in order]
        while eng.pending():
            eng.step(4)
        return {i: eng.tokens(r) for i, r in zip(order, rids)}

    assert run([0, 1, 2]) == run([2, 0, 1])
    eng = TBatch(tlm, tproc, slots=2, window=256)
    a = eng.submit(PROMPTS[0], max_tokens=12, temperature=1.2)
    b = eng.submit(PROMPTS[0], max_tokens=12, temperature=1.2)
    while eng.pending():
        eng.step(4)
    assert eng.tokens(a) != eng.tokens(b)


def test_image_prompt_sampled_top_k_1_is_greedy(tmp_path):
    """An image prompt (``tiny_vision``) sampled with top_k = 1 decodes
    the JAX package's greedy text."""
    from test_torch_vision import images_for, load_pair, vision_checkpoint

    from phi_3_vision_mlx_tpu import api as JAPI
    from phi_3_vision_mlx_tpu_torch import api as TAPI

    (jlm, jproc), (tlm, tproc) = load_pair(vision_checkpoint(tmp_path, "tv"))
    kw = dict(max_tokens=10, verbose=False, stream=False, mute=True, images=images_for(1))
    want = JAPI.generate("What is shown in this image?", preload=(jlm, jproc), **kw)
    got = TAPI.generate("What is shown in this image?", preload=(tlm, tproc), sample=True, top_k=1,
                        seed=2, **kw)
    assert got == want
