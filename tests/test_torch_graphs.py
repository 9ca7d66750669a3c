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
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from test_torch_batching import PLAN, _drive  # noqa: E402
from test_torch_model import FP32_ATOL, PROMPT, ReplayJaxCache, make_checkpoint  # noqa: E402
from test_torch_model import one_thread  # noqa: E402,F401  (autouse: one torch thread)

from phi_3_vision_mlx_tpu import api as JAPI  # noqa: E402
from phi_3_vision_mlx_tpu.api import _load as jax_load  # noqa: E402
from phi_3_vision_mlx_tpu.core.config import KVQuantConfig  # noqa: E402
from phi_3_vision_mlx_tpu.engine import engine as JE  # noqa: E402
from phi_3_vision_mlx_tpu.engine.batching import BatchEngine as JBatch  # noqa: E402
from phi_3_vision_mlx_tpu.engine.paging import PagedBatchEngine as JPaged  # noqa: E402
from phi_3_vision_mlx_tpu_torch import api as TAPI  # noqa: E402
from phi_3_vision_mlx_tpu_torch.api import _load as torch_load  # noqa: E402
from phi_3_vision_mlx_tpu_torch.core.convert import from_numpy_params  # noqa: E402
from phi_3_vision_mlx_tpu_torch.engine import engine as TE  # noqa: E402
from phi_3_vision_mlx_tpu_torch.engine import graphs as TG  # noqa: E402
from phi_3_vision_mlx_tpu_torch.engine import state as TS  # noqa: E402
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
        with torch.no_grad():  # a training step touches leaves that require grad
            before = [t.clone() for t in self.touched]
        yield
        with torch.no_grad():
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


def test_no_garbage_collection_during_a_capture():
    """The capture runs with Python's garbage collector off (a collection
    there could destroy a dead entry's graph, which breaks a capture on the
    card), and turns it back on after, also when the capture raises."""
    seen = []
    g = StubStepGraph(lambda: seen.append(gc.isenabled()), "cpu", graphs=True)
    assert gc.isenabled()
    g.capture()
    assert seen == [True, False] and gc.isenabled()  # the warm-up's step, the capture's

    def boom():
        if not gc.isenabled():
            raise RuntimeError("capture failed")

    with pytest.raises(RuntimeError, match="capture failed"):
        StubStepGraph(boom, "cpu", graphs=True).capture()
    assert gc.isenabled()


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


def test_entries_keep_within_a_byte_budget(pair):
    """A model's kept entries hold at most ``lm.keep_bytes`` (on the card
    ``GRAPH_KEEP_SHARE`` of its memory): an entry larger than that is closed
    when its request ends, the least recently finished entries go first,
    and an entry of the key that another request made meanwhile is closed
    when this one replaces it.  The repair that lets two requests whose
    caches fill most of the card run one after the other: the dense
    128K-token entry (48 GiB, ``cache_bytes`` reckoned from the shapes) is
    not kept."""
    _, (tlm, tproc) = pair
    lm = TE.LM(tlm.cfg, tlm.params, device="cpu")
    assert lm.keep_bytes == float("inf")
    lm.graphs = True  # the entries' bookkeeping; nothing decodes
    dict_input = tproc(PROMPT)
    keys = [TE.prefill_shape(dict_input, n)[::2] for n in (24, 200, 600)]
    assert len(set(keys)) == 3
    small, mid, big = (TE.prefill_decoder(lm, dict_input, n)[0] for n in (24, 200, 600))
    n_small, n_mid = TS.state_bytes(small.state), TS.state_bytes(mid.state)
    b, window = keys[2]
    assert TS.cache_bytes(lm.cfg, b, window, torch.float32) <= TS.state_bytes(big.state)
    lm.keep_bytes = n_small + n_mid
    TE.release_decoder(lm, big)
    assert not lm.decoders and big.state is None  # larger than the budget: closed
    TE.release_decoder(lm, small)
    TE.release_decoder(lm, mid)
    assert list(lm.decoders) == keys[:2]
    lm.keep_bytes = n_small + n_mid - 1  # the older entry goes
    first, _ = TE.prefill_decoder(lm, dict_input, 200)  # takes the kept entry
    meanwhile, _ = TE.prefill_decoder(lm, dict_input, 200)  # makes another
    assert first is mid and lm.entry_uses == {"made": 4, "reused": 1}
    TE.release_decoder(lm, first)
    TE.release_decoder(lm, meanwhile)
    assert list(lm.decoders.items()) == [(keys[1], meanwhile)]
    assert small.state is None and first.state is None and meanwhile.state is not None


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


# --- constrained decoding: the score step, the beam read, the cache-free pass --

CONSTRAINTS = [(3, " The correct answer is"), (2, " A"), "ABC"]  # steps of 1 + 22 and 1 + 2 rows


@pytest.mark.parametrize("cache", list(CACHES))
def test_constrained_steps_have_no_host_sync(ckpt, cache):
    """An entry's score steps (advance 0 and 1, 3 and 23 rows: one and two
    launches of the decode route), its beam read (3 x 23 rows) and a
    cache-free pass, run eagerly on their static tensors: no aten op that
    waits for the device or sizes its output from data, on the dense, int4
    and int8 caches."""
    _, (tlm, tproc) = _pair(ckpt, CACHES[cache])
    entry, _, state, _, _ = TE.prefill_entry(tlm, tproc(PROMPT), 64)
    ids = torch.arange(3, 3 + 23)[None]
    for l, advance in ((3, 0), (3, 1), (23, 0), (23, 1)):
        step = entry.score_step(l, advance)
        step.inputs[0].copy_(ids[:, :l])
        ops = _recorded(step.graph.step)
        _no_sync(ops)
        assert "index_copy_" in ops  # the chunk's k/v at the device offset
    beam = entry.beam_step(23, 3)
    beam.inputs[0].copy_(ids.expand(3, -1))
    _no_sync(_recorded(beam.graph.step))
    nocache = TE.NocachePass(tlm, 2, 64)
    nocache.step.inputs[0].fill_(7)
    nocache.step.inputs[3].fill_(True)
    _no_sync(_recorded(nocache.step.graph.step))


def stub_static_steps(monkeypatch, lm):
    """Give every static step of ``lm`` made from now on a stub capture
    (``StubStepGraph``: the capture runs nothing, as on the card) that puts
    back the taken entries' states and the step's ``save``; returns the
    list of the stubs made."""
    made = []

    def make(step, device, graphs, save=(), pool=None):  # no pool: nothing is captured
        touched = [t for e in list(lm.taken) if e.state is not None for t in tensors_of(e.state)]
        made.append(StubStepGraph(step, "cpu", graphs, save=save, touched=[*touched, *save]))
        return made[-1]

    monkeypatch.setattr(TG, "StepGraph", make)
    return made


class StepOutputs:
    """Every output of ``lm``'s score, beam and cache-free steps, copied, in
    call order."""

    def __init__(self, lm, monkeypatch):
        self.outs = []
        for name in ("score_fn", "beam_fn", "nocache_fn"):
            monkeypatch.setattr(lm, name, self._wrap(getattr(lm, name)))

    def _wrap(self, make):
        def maker(*a, **kw):
            fn = make(*a, **kw)

            def call(*args):
                out = fn(*args)
                self.outs.append((out[0] if isinstance(out, tuple) else out).clone())
                return out

            return call

        return maker


def _questions(lm, proc, api=TAPI):
    """``api.choose`` and ``api.constrain``, greedy and beam."""
    kw = dict(preload=(lm, proc), verbose=False)
    return [api.choose(["Pick!", "Choose one of them!"], choices="ABC", **kw)] + [
        api.constrain("Which is larger, 3 or 5?", constraints=CONSTRAINTS, use_beam=beam, **kw)
        for beam in (False, True)]


@pytest.mark.parametrize("cache", list(CACHES))
def test_stub_capture_keeps_constrained_decoding(ckpt, cache, monkeypatch):
    """``api.choose`` and ``api.constrain`` (greedy and beam, a score step
    of 1 + 22 rows) with graphs, every step captured at its first call
    through the stub, give the eager run's outputs and every step's
    log-probs exactly; with the dense cache also the JAX package's
    answers (fp32)."""
    (jlm, jproc), (tlm, tproc) = _pair(ckpt, CACHES[cache])
    with monkeypatch.context() as m:
        eager = StepOutputs(tlm, m)
        want = _questions(tlm, tproc)
    lm = TE.LM(tlm.cfg, tlm.params, device="cpu")
    lm.graphs = True
    made = stub_static_steps(monkeypatch, lm)
    graphed = StepOutputs(lm, monkeypatch)
    assert _questions(lm, tproc) == want
    assert made and all(g.graph is not None for g in made)
    assert len(graphed.outs) == len(eager.outs) > 0
    assert all(torch.equal(g, e) for g, e in zip(graphed.outs, eager.outs))
    if cache == "dense":
        assert want == _questions(jlm, jproc, JAPI)


def test_a_second_question_replays_its_entries(pair, monkeypatch):
    """The same questions again: every entry is reused (``entry_uses``)
    and no step is made or captured anew; a state prefilled outside an
    entry, handed to a step, raises (no eager fallback)."""
    _, (tlm, tproc) = pair
    lm = TE.LM(tlm.cfg, tlm.params, device="cpu")
    lm.graphs = True
    made = stub_static_steps(monkeypatch, lm)
    first = _questions(lm, tproc)
    n_made, uses = len(made), dict(lm.entry_uses)
    assert uses["made"] >= 3 and not lm.taken
    assert _questions(lm, tproc) == first
    assert len(made) == n_made and lm.entry_uses["made"] == uses["made"]
    assert lm.entry_uses["reused"] == uses.get("reused", 0) + sum(uses.values())  # every request
    _, state, _, window = TE.run_prefill(lm, tproc(PROMPT), 40)
    ids = torch.zeros((1, 3), dtype=torch.long)
    with pytest.raises(ValueError, match="belongs to none"):
        lm.score_fn(1, 3, window, advance=0)(lm.params, ids, state)
    with pytest.raises(ValueError, match="belongs to none"):
        lm.beam_fn(3, 3, window, 3)(lm.params, ids.expand(3, -1), state)


def test_entry_budget_counts_graph_pools(pair, monkeypatch):
    """An entry's bytes are its tensors and its graphs' pools: a cache-free
    entry or a question's decoder whose pools pass ``lm.keep_bytes`` is
    closed when its call ends, not kept."""
    _, (tlm, tproc) = pair
    lm = TE.LM(tlm.cfg, tlm.params, device="cpu")
    lm.graphs = True
    stub_static_steps(monkeypatch, lm)
    _questions(lm, tproc)
    nocache = next(e for k, e in lm.decoders.items() if k[0] == "nocache")
    dec = next(e for k, e in lm.decoders.items() if k[0] != "nocache" and e.steps)
    lm.keep_bytes = 2**30
    for entry, graph in ((nocache, nocache.step.graph), (dec, next(iter(dec.steps.values())).graph)):
        before, key = entry.held_bytes(), entry.key
        graph.pool_bytes = 2**30
        assert entry.held_bytes() == before + 2**30
        lm.decoders.pop(key)  # taken, as a call takes it
        TE.release_decoder(lm, entry)
        assert key not in lm.decoders
    assert nocache.step is None and dec.state is None
