"""The capturable decode steps (``engine/graphs.py``) on the CPU.

On the card each decode step of the single-stream, slot and paged engines
is one CUDA graph replay; here the same step code runs eagerly on its static
tensors (the token or ``active`` mask, the device offset, the output ring),
which is what the card captures.  The tests hold it to the JAX engine's
compiled chunk (``LM.chunk_fn``) in fp32, show that no captured step holds a
host sync or a shape that depends on data, pin the device offset to its
host mirror, the launch accounting under capture (through a stub capture
context), and the continuous engines' streams under pipelining.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from test_torch_batching import PLAN, _drive  # noqa: E402
from test_torch_model import FP32_ATOL, PROMPT, ReplayJaxCache, make_checkpoint  # noqa: E402

from phi_3_vision_mlx_tpu.api import _load as jax_load  # noqa: E402
from phi_3_vision_mlx_tpu.core.config import KVQuantConfig  # noqa: E402
from phi_3_vision_mlx_tpu.engine import engine as JE  # noqa: E402
from phi_3_vision_mlx_tpu.engine.batching import BatchEngine as JBatch  # noqa: E402
from phi_3_vision_mlx_tpu.engine.paging import PagedBatchEngine as JPaged  # noqa: E402
from phi_3_vision_mlx_tpu_torch.api import _load as torch_load  # noqa: E402
from phi_3_vision_mlx_tpu_torch.core.convert import from_numpy_params  # noqa: E402
from phi_3_vision_mlx_tpu_torch.engine import engine as TE  # noqa: E402
from phi_3_vision_mlx_tpu_torch.engine import graphs as TG  # noqa: E402
from phi_3_vision_mlx_tpu_torch.engine.batching import BatchEngine as TBatch  # noqa: E402
from phi_3_vision_mlx_tpu_torch.engine.paging import PagedBatchEngine as TPaged  # noqa: E402
from phi_3_vision_mlx_tpu_torch.models import phi3 as TM  # noqa: E402
from phi_3_vision_mlx_tpu_torch.models.preprocess import Phi3Processor  # noqa: E402
from phi_3_vision_mlx_tpu_torch.ops.kernels import _build  # noqa: E402

CHUNKS = (8, 32, 5)  # the ramp's first two chunks and a ragged tail
CACHES = {"dense": None, "int4": 4, "int8": 8}
# A host sync, an output shape that depends on the data, or a tensor made
# from host data (``lift_fresh``: on the card a host-to-device copy, which a
# capture refuses): none can be captured in a CUDA graph.
SYNCS = {"_local_scalar_dense", "nonzero", "masked_select", "item", "lift_fresh"}


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return make_checkpoint(tmp_path_factory.mktemp("ckpt"), "tiny")


def _pair(path, bits):
    """(JAX lm, proc), (port lm, proc) with the cache of ``bits`` (None:
    dense)."""
    quantized = bits is not None
    jlm, jproc = jax_load(path, use_quantized_cache=quantized)
    tlm, tproc = torch_load(path, device="cpu", use_quantized_cache=quantized)
    if quantized:
        kvq = KVQuantConfig(bits=bits)
        jlm = JE.LM(jlm.cfg.replace(kv_quant=kvq), jlm.params, model_path=path)
        tlm = TE.LM(tlm.cfg.replace(kv_quant=kvq), tlm.params, model_path=path, device="cpu")
    return (jlm, jproc), (tlm, tproc)


@pytest.mark.parametrize("cache", list(CACHES))
def test_step_matches_jax_chunk_fn(ckpt, cache, monkeypatch):
    """Chunks of 8, 32 and 5 steps through the port's Decoder (the
    capturable step, eagerly, on its static token, ring and device offset)
    give the JAX ``chunk_fn``'s tokens exactly and its max and EOS
    log-probs within FP32_ATOL.  The quantized caches write the JAX
    package's entries (``ReplayJaxCache``: a 1e-7 difference can round a
    value to the neighbouring level)."""
    (jlm, jproc), (tlm, _) = _pair(ckpt, CACHES[cache])
    dict_input = jproc(PROMPT)
    max_tokens = 1 + sum(CHUNKS)
    jl, jstate, _, window = JE.run_prefill(jlm, dict_input, max_tokens)
    tok = jnp.asarray(np.argmax(np.asarray(jl), axis=-1).astype(np.int32)[:, None])
    want = []
    for i, n in enumerate(CHUNKS):
        tok, jstate, toks, maxlp, eoslp = jlm.chunk_fn(1, window, n)(
            jlm.params, tok, jstate, jax.random.PRNGKey(i))
        want.append(tuple(map(np.asarray, (toks, maxlp, eoslp))))
    if cache != "dense":
        replay = ReplayJaxCache(jstate, CACHES[cache])
        monkeypatch.setattr(TM, "update_layer_chunk", replay)
    dec, first = TE.prefill_decoder(tlm, dict_input, max_tokens)
    assert int(first[0, 0]) == int(np.argmax(np.asarray(jl)[0]))
    assert dec.graph.graphs is False and dec.state.window == window
    for n, (wt, wm, we) in zip(CHUNKS, want):
        toks, maxlp, eoslp = dec.chunk(n)
        assert toks.shape == (n, 1)
        np.testing.assert_array_equal(toks.numpy(), wt)
        np.testing.assert_allclose(maxlp.numpy(), wm, rtol=0, atol=FP32_ATOL)
        np.testing.assert_allclose(eoslp.numpy(), we, rtol=0, atol=FP32_ATOL)
    if cache != "dense":
        replay.check()


class OpRecorder(TorchDispatchMode):
    """Every aten op dispatched inside, by name."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(func._overloadpacket.__name__)
        return func(*args, **(kwargs or {}))


def _recorded(step):
    with OpRecorder() as rec:
        step()
    return rec.ops


@pytest.mark.parametrize("cache", list(CACHES))
def test_single_stream_step_has_no_host_sync(ckpt, cache):
    """One single-stream step (the dense, int4 and int8 caches): no aten op
    that waits for the device or sizes its output from data; the cache is
    written at device positions (``index_copy_``)."""
    _, (tlm, tproc) = _pair(ckpt, CACHES[cache])
    dec, _ = TE.prefill_decoder(tlm, tproc(PROMPT), 16)
    dec.ring.start(1)
    ops = _recorded(dec.graph.step)
    assert ops and not SYNCS & set(ops), sorted(SYNCS & set(ops))
    assert "index_copy_" in ops and "index_select" in ops


@pytest.fixture(scope="module")
def pair(ckpt):
    jlm, jproc = jax_load(ckpt)
    tree = jax.tree_util.tree_map(np.asarray, jlm.params)
    return (jlm, jproc), (TE.LM(jlm.cfg, from_numpy_params(tree, jlm.cfg), device="cpu"),
                          Phi3Processor(ckpt))


@pytest.mark.parametrize("paged", [False, True], ids=["slots", "paged"])
def test_slot_step_has_no_host_sync(pair, paged):
    """One step of the slot and of the paged engine, two requests active."""
    _, (tlm, tproc) = pair
    eng = (TPaged(tlm, tproc, slots=3, window=256, page_size=32) if paged
           else TBatch(tlm, tproc, slots=3, window=256))
    for p in eng.prepare_many(PLAN[0][1], [dict(max_tokens=8)] * 2):
        eng.admit(p)
    eng.step(1)
    eng.decoder.active.copy_(torch.tensor([i in eng.by_slot for i in range(3)]))
    eng.decoder.ring.start(1)
    ops = _recorded(eng.decoder.graph.step)
    assert ops and not SYNCS & set(ops), sorted(SYNCS & set(ops))


def _mirror_matches(state):
    assert state.pos.shape == (1,) and state.pos.dtype == torch.int32
    assert int(state.pos[0]) == state.offset


def test_device_offset_tracks_its_mirror(pair, monkeypatch):
    """The device offset equals the host mirror after a chunked prefill,
    after every chunk, after an extend through the flash route (L > 16)
    and one through the decode route (L <= 16), and after scoring without
    committing (advance 0)."""
    _, (tlm, tproc) = pair
    monkeypatch.setattr(TE, "PREFILL_CHUNK", 64)
    dict_input = tproc(PROMPT.replace("lighthouses", "lighthouses " * 12))
    dec, _ = TE.prefill_decoder(tlm, dict_input, 96)
    assert dec.state.offset > 64
    _mirror_matches(dec.state)
    for n in CHUNKS:
        dec.chunk(n)
        _mirror_matches(dec.state)
    state = dec.state
    for length, advance in ((20, None), (4, None), (3, 0), (3, 1)):
        ids = torch.full((1, length), 1000 + length)
        res = TM.decode_forward(tlm.params, tlm.cfg, state, ids, advance=advance)
        assert res.state.pos is state.pos
        assert res.state.offset == state.offset + (length if advance is None else advance)
        state = res.state
        _mirror_matches(state)


def test_prefill_into_a_used_state_equals_a_fresh_one(pair):
    """A graph entry's next request prefills into the entry's tensors: the
    logits and every tensor of the state equal a fresh prefill's."""
    _, (tlm, tproc) = pair
    used, _ = TE.prefill_decoder(tlm, tproc("A first request, decoded for a while."), 40)
    used.chunk(32)
    dict_input = tproc(PROMPT)
    b, _, window = TE.prefill_shape(dict_input, 40)
    assert used.state.window == window
    fresh_logits, fresh, *_ = TE.run_prefill(tlm, dict_input, 40)
    logits, state, *_ = TE.run_prefill(tlm, dict_input, 40, into=used.state)
    assert state.k is used.state.k and state.pos is used.state.pos
    assert torch.equal(logits, fresh_logits) and state.offset == fresh.offset
    for name in ("k", "v", "pos", "valid", "cos", "sin"):
        assert torch.equal(getattr(state, name), getattr(fresh, name)), name


def test_graphs_need_a_cuda_device(pair):
    """No fallback: asking for graphs off the card raises."""
    _, (tlm, _) = pair
    assert TE.LM(tlm.cfg, tlm.params, device="cpu").graphs is False
    with pytest.raises(ValueError, match="CUDA graphs"):
        TE.LM(tlm.cfg, tlm.params, device="cpu", graphs=True)


def fake_kernel():
    """A wrapper that counts its launches as the kernel wrappers do."""
    _build.count_launch(fake_kernel)


fake_kernel.launches = 0


class _StubGraph:
    def __init__(self):
        self.body = None

    def replay(self):
        with _build.recording():  # a replay runs no host code: nothing counts here
            self.body()


class StubStepGraph(TG.StepGraph):
    """StepGraph with the CUDA calls stubbed: the warm-up runs the step; the
    "capture" runs it under the launch recording, as the real capture does,
    then puts back every tensor in ``touched`` (all that the step may
    write), since a real capture runs nothing on the device; the replays run
    the kept step."""

    def __init__(self, step, device, graphs, save=(), touched=()):
        super().__init__(step, device, graphs, save=save)
        self.touched = tuple(touched)

    def new_graph(self):
        return _StubGraph()

    @contextlib.contextmanager
    def capturing(self, graph):
        graph.body = self.step
        before = [t.clone() for t in self.touched]
        yield
        for t, b in zip(self.touched, before):
            t.copy_(b)

    def warm_up(self):
        self.step()


def tensors_of(*objs):
    """The tensors that ``objs`` (a state, a decoder, a ring) hold as
    attributes."""
    return [v for o in objs for v in vars(o).values() if isinstance(v, torch.Tensor)]


def stub_graph(step_owner, state):
    """Swap ``step_owner``'s (a Decoder's or a SlotStep's) eager StepGraph
    for a stub that captures at its first call, keeping its ``save``."""
    g = step_owner.graph
    step_owner.graph = StubStepGraph(g.step, "cpu", graphs=True, save=g.save,
                                     touched=tensors_of(state, step_owner, step_owner.ring))
    return step_owner.graph


def test_launch_counts_record_at_capture_and_add_per_replay():
    """Eagerly every launch counts; during a capture the launches are
    recorded, not counted; each replay adds the recorded launches; the
    warm-up's launches run and count; ``save`` undoes the warm-up's
    step."""
    counter = torch.zeros((1,), dtype=torch.long)

    def step():
        fake_kernel()
        fake_kernel()
        counter.add_(1)

    fake_kernel.launches = 0
    TG.StepGraph(step, "cpu", graphs=False)()
    assert fake_kernel.launches == 2 and int(counter) == 1
    fake_kernel.launches = 0
    g = StubStepGraph(step, "cpu", graphs=True, save=(counter,), touched=(counter,))
    g.capture()
    assert g.launches == {fake_kernel: 2} and fake_kernel.launches == 2  # the warm-up's
    assert int(counter) == 1  # the warm-up's step undone; the capture ran nothing
    for _ in range(5):
        g()
    assert fake_kernel.launches == 2 + 5 * 2 and int(counter) == 6
    with _build.recording() as outer:
        fake_kernel()
        with _build.recording() as inner:
            fake_kernel()
        fake_kernel()
    assert outer == {fake_kernel: 2} and inner == {fake_kernel: 1}
    assert fake_kernel.launches == 12


@pytest.mark.parametrize("chunks", [CHUNKS, (TE.DECODE_CHUNK_MAX,)], ids=["ramp", "full-ring"])
def test_capture_inside_the_first_chunk_keeps_its_tokens(pair, chunks):
    """A request whose own first chunk captures the graph (a new key, or
    one evicted) gives the eager decoder's tokens and statistics, chunk for
    chunk: the warm-up's step is undone (the offset, the token and the
    ring's step index), so the replays fill rows 0..n-1, also for a chunk
    as long as the ring."""
    _, (tlm, tproc) = pair
    dict_input = tproc(PROMPT)
    max_tokens = 1 + sum(chunks)
    eager, e_first = TE.prefill_decoder(tlm, dict_input, max_tokens)
    dec, g_first = TE.prefill_decoder(tlm, dict_input, max_tokens)
    g = stub_graph(dec, dec.state)
    assert torch.equal(e_first, g_first) and g.graph is None
    for n in chunks:
        want = [t.clone() for t in eager.chunk(n)]
        got = dec.chunk(n)
        assert g.graph is not None
        for w, t in zip(want, got):
            assert torch.equal(w, t)
    assert dec.state.offset == eager.state.offset
    assert torch.equal(dec.state.pos, eager.state.pos) and torch.equal(dec.state.k, eager.state.k)


def test_entries_serve_one_request_at_a_time(pair):
    """With graphs an entry leaves ``LM.decoders`` while its request
    decodes: a second request of the same key meanwhile makes its own
    decoder (and state), and each decodes as it would alone; a finished
    request's entry is the next one's, and the least recently finished
    beyond GRAPH_ENTRIES are dropped."""
    _, (tlm, tproc) = pair
    lm = TE.LM(tlm.cfg, tlm.params, device="cpu")
    lm.graphs = True  # the entries' bookkeeping, with stub captures
    dict_input = tproc(PROMPT)
    alone, _ = TE.prefill_decoder(tlm, dict_input, 24)
    want = [t.clone() for t in alone.chunk(16)]
    a, _ = TE.prefill_decoder(lm, dict_input, 24)
    b, _ = TE.prefill_decoder(lm, dict_input, 24)
    assert a is not b and a.state.k is not b.state.k and not lm.decoders
    stub_graph(a, a.state), stub_graph(b, b.state)
    assert all(torch.equal(w, t) for w, t in zip(want, a.chunk(16)))
    assert all(torch.equal(w, t) for w, t in zip(want, b.chunk(16)))
    TE.release_decoder(lm, a)
    TE.release_decoder(lm, b)
    assert list(lm.decoders.values()) == [b]
    c, _ = TE.prefill_decoder(lm, dict_input, 24)
    assert c is b and lm.entry_uses == {"made": 2, "reused": 1}
    TE.release_decoder(lm, c)
    for i in range(TE.GRAPH_ENTRIES):
        TE.release_decoder(lm, TE.prefill_decoder(lm, dict_input, 200 + 128 * i)[0])
    assert len(lm.decoders) == TE.GRAPH_ENTRIES and c not in lm.decoders.values()


@pytest.mark.parametrize("paged", [False, True], ids=["slots", "paged"])
def test_capture_inside_the_first_chunk_keeps_the_streams(pair, jax_streams, paged):
    """The slot and paged engines whose first dispatched chunk captures the
    graph (no ``capture()`` before serving), pipelined two deep, give the
    JAX engines' streams."""
    _, (tlm, tproc) = pair
    eng = (TPaged(tlm, tproc, slots=3, window=256, page_size=32, pipeline_depth=2) if paged
           else TBatch(tlm, tproc, slots=3, window=256, pipeline_depth=2))
    g = stub_graph(eng.decoder, eng.state)
    assert _drive(eng, PLAN, pipelined=True) == jax_streams[paged]
    assert g.graph is not None


@pytest.fixture(scope="module")
def jax_streams(pair):
    (jlm, jproc), _ = pair
    return {False: _drive(JBatch(jlm, jproc, slots=3, window=256), PLAN),
            True: _drive(JPaged(jlm, jproc, slots=3, window=256, page_size=32), PLAN)}


@pytest.mark.parametrize("paged", [False, True], ids=["slots", "paged"])
def test_static_buffers_keep_the_streams_when_pipelined(pair, jax_streams, paged):
    """The slot and paged engines, with their static ``active`` mask and
    output ring, pipelined two chunks deep (the ring is overwritten by the
    next chunk before the first is collected), give the JAX engines'
    streams; a reset in place after a failure serves again."""
    _, (tlm, tproc) = pair
    make = ((lambda: TPaged(tlm, tproc, slots=3, window=256, page_size=32, pipeline_depth=2))
            if paged else (lambda: TBatch(tlm, tproc, slots=3, window=256, pipeline_depth=2)))
    eng = make()
    decoder, k = eng.decoder, eng.state.k
    assert _drive(eng, PLAN, pipelined=True) == jax_streams[paged]
    eng.fail_all_active("test reset")
    assert eng.decoder is decoder and eng.state.k is k and not eng.state.valid.any()
    assert _drive(eng, PLAN, pipelined=True) == jax_streams[paged]


# --- sampling and speculation: the sampled step and the verify pass -----------

SAMPLER = (0.8, 0.9, 20, 0.05)


@pytest.fixture
def one_thread():
    """One intra-op thread for the sampled and speculative runs below: their
    many small sorts and noise draws would otherwise keep every thread of
    the suite's parallel workers spinning."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _no_sync(ops):
    assert ops and not SYNCS & set(ops), sorted(SYNCS & set(ops))


@pytest.mark.parametrize("cache", list(CACHES))
def test_single_stream_sampled_step_and_verify_pass_have_no_host_sync(ckpt, cache, one_thread):
    """The sampled decode step and the verify pass, greedy and sampled, of
    the single-stream decoder (dense, int4, int8 caches)."""
    _, (tlm, tproc) = _pair(ckpt, CACHES[cache])
    dict_input = tproc(PROMPT)
    dec, _ = TE.prefill_decoder(tlm, dict_input, 32, sampler=SAMPLER, seed=1)
    dec.ring.start(1)
    _no_sync(_recorded(dec.sampled_graph.step))
    for sampler in (None, SAMPLER):
        dec, _ = TE.prefill_decoder(tlm, dict_input, 32, sampler=sampler, seed=1)
        spec = dec.spec_pass(3)
        spec.start(TE.pad_prompt_inputs(dict_input, dec.state.offset)[0])
        spec.left.fill_(10)
        spec.ring.start(1)
        ops = _recorded(spec.graph.step)
        _no_sync(ops)
        assert "index_copy_" in ops and "scatter_" in ops


@pytest.mark.parametrize("paged", [False, True], ids=["slots", "paged"])
def test_slot_sampled_step_and_verify_pass_have_no_host_sync(pair, paged, one_thread):
    """The slot and paged engines' sampled step, and their verify pass,
    greedy and sampled, with a greedy and a sampled request active."""
    _, (tlm, tproc) = pair
    for spec_k in (0, 3):
        eng = (TPaged(tlm, tproc, slots=3, window=256, page_size=32, spec_k=spec_k) if paged
               else TBatch(tlm, tproc, slots=3, window=256, spec_k=spec_k))
        eng.submit(PLAN[0][1][0], max_tokens=8)
        eng.submit(PLAN[0][1][1], max_tokens=8, temperature=0.8, top_p=0.9, seed=2)
        eng.step(1)
        assert eng._sampling()
        step = eng.spec or eng.decoder
        step.active.copy_(torch.tensor([i in eng.by_slot for i in range(3)]))
        for graph in (step.graph, step.sampled_graph):
            step.ring.start(1)
            _no_sync(_recorded(graph.step))


def _stub(owner, name, *objs):
    """Swap ``owner.<name>`` (an eager StepGraph) for a stub that captures at
    its first call; ``objs`` hold every tensor the step may write."""
    g = getattr(owner, name)
    setattr(owner, name, StubStepGraph(g.step, "cpu", graphs=True, save=g.save,
                                       touched=tensors_of(*objs)))
    return getattr(owner, name)


def test_capture_keeps_the_sampled_and_speculative_streams(pair, one_thread):
    """The sampled step and the verify pass (greedy and sampled) captured
    inside their first chunk (the warm-up undone through ``save``: the
    offset, the token, the history, the budget, the generator's counters)
    give the eager runs' rows chunk for chunk."""
    _, (tlm, tproc) = pair
    dict_input = tproc(PROMPT)

    def run(stubbed, sampler, spec):
        dec, first = TE.prefill_decoder(tlm, dict_input, 64, sampler=sampler, seed=7)
        objs = (dec.state, dec, dec.ring) + ((dec.knobs, dec.knobs.gen) if sampler else ())
        if spec:
            owner = dec.spec_pass(3)
            owner.start(TE.pad_prompt_inputs(dict_input, dec.state.offset)[0])
            objs += (owner, owner.ring)
            name, chunk = "graph", lambda n: owner.chunk(n, 40)
        else:
            owner, name, chunk = dec, "sampled_graph" if sampler else "graph", dec.chunk
        g = _stub(owner, name, *objs) if stubbed else None
        rows = [first.clone()] + [t.clone() for n in (5, 3) for t in chunk(n)]
        assert g is None or g.graph is not None
        return rows

    for sampler, spec in ((SAMPLER, False), (None, True), (SAMPLER, True)):
        want, got = run(False, sampler, spec), run(True, sampler, spec)
        assert all(torch.equal(w, t) for w, t in zip(want, got)), (sampler, spec)


@pytest.mark.parametrize("paged", [False, True], ids=["slots", "paged"])
def test_capture_keeps_the_slot_engines_sampled_and_speculative_streams(pair, paged, one_thread):
    """The slot and paged engines with spec_k = 3 and a sampled request,
    their graphs captured inside the first chunk, pipelined two deep: the
    eager engines' streams."""
    _, (tlm, tproc) = pair

    def run(stubbed):
        eng = (TPaged(tlm, tproc, slots=3, window=256, page_size=32, spec_k=3, pipeline_depth=2)
               if paged else TBatch(tlm, tproc, slots=3, window=256, spec_k=3, pipeline_depth=2))
        if stubbed:
            for name in ("graph", "sampled_graph"):
                _stub(eng.spec, name, eng.state, eng.spec, eng.spec.ring, eng.knobs, eng.knobs.gen)
        rids = [eng.submit(PLAN[0][1][0], max_tokens=20),
                eng.submit(PLAN[0][1][1], max_tokens=20, temperature=0.9, seed=5)]
        while eng.pending():
            eng.step_pipelined(4)
        eng.flush()
        return [eng.tokens(r) for r in rids]

    assert run(True) == run(False)
