"""The port's continuous-batching engines and scheduler against the JAX
package's, on the tiny preset, 4-bit weights, fp32, one checkpoint.

The JAX engines and the port's are driven through the same schedule (the
same admissions between the same steps), so their page allocations match
too.  In fp32 both run the same math with the sums in another order, and the
greedy token streams must be identical: the slot engine, the dense page
pool, a pool small enough to preempt and resume, batched admission, and the
pipelined pump.  With the int4 pool the port writes the JAX engine's
quantized entries in place of its own (``ReplayJaxPool``; see
tests/test_torch_model.py:ReplayJaxCache for why) and the port's own
entries are held to them: equal but for a few values one level apart.
"""

import json
import threading
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_model import MAX_FLIP_SHARE, ReplayJaxCache, make_checkpoint  # noqa: E402

from phi_3_vision_mlx_tpu.api import _load as jax_load  # noqa: E402
from phi_3_vision_mlx_tpu.engine.batching import BatchEngine as JBatch  # noqa: E402
from phi_3_vision_mlx_tpu.engine.paging import PagedBatchEngine as JPaged  # noqa: E402
from phi_3_vision_mlx_tpu.serve import server as JS  # noqa: E402
from phi_3_vision_mlx_tpu_torch.core.convert import from_jax_paged_pool, from_numpy_params  # noqa: E402
from phi_3_vision_mlx_tpu_torch.engine import paging as TP  # noqa: E402
from phi_3_vision_mlx_tpu_torch.engine import state as TS  # noqa: E402
from phi_3_vision_mlx_tpu_torch.engine.batching import BatchEngine as TBatch  # noqa: E402
from phi_3_vision_mlx_tpu_torch.engine.engine import LM  # noqa: E402
from phi_3_vision_mlx_tpu_torch.engine.paging import PagedBatchEngine as TPaged  # noqa: E402
from phi_3_vision_mlx_tpu_torch.models import phi3 as TM  # noqa: E402
from phi_3_vision_mlx_tpu_torch.models.preprocess import Phi3Processor  # noqa: E402
from phi_3_vision_mlx_tpu_torch.serve import server as TSV  # noqa: E402

PROMPTS = ["Tell me about the sea.", "Write a poem in winter, with snow and pines.",
           "Explain tides briefly."]


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """(JAX (lm, proc), port (lm, proc)) over one checkpoint; the port's
    weights come through ``from_numpy_params``."""
    path = make_checkpoint(tmp_path_factory.mktemp("ckpt"), "tiny")
    jlm, jproc = jax_load(path)
    tree = jax.tree_util.tree_map(np.asarray, jlm.params)
    tlm = LM(jlm.cfg, from_numpy_params(tree, jlm.cfg), device="cpu")
    return (jlm, jproc), (tlm, Phi3Processor(path))


def _drive(eng, plan, chunk=4, pipelined=False):
    """Run ``plan``: (tick, [prompts], max_tokens) admissions, batched
    through prepare_many and adopted when the engine can take them, between
    steps of ``chunk``.  Returns each request's tokens in plan order."""
    queue, rids, tick = list(plan), [], 0
    while queue or eng.pending():
        while queue and queue[0][0] <= tick:
            _, prompts, n = queue[0]
            prepared = eng.prepare_many(prompts, [dict(max_tokens=n)] * len(prompts))
            if not all(eng.can_admit(p) for p in prepared[:1]):
                break
            queue.pop(0)
            rids += [eng.admit(p) for p in prepared]
        if pipelined:
            eng.step_pipelined(chunk)
        else:
            eng.step(chunk)
        tick += 1
    eng.flush()
    return [eng.tokens(r) for r in rids]


# Two requests admitted together, a third mid-run into the third slot.
PLAN = [(0, PROMPTS[:2], 24), (3, PROMPTS[2:], 16)]


@pytest.fixture(scope="module")
def jax_streams(pair):
    """The JAX engines' streams for PLAN: the slot engine, and the page pool
    at page sizes 32 (pages below the prompt bucket) and 128 (above it: a
    partial last page)."""
    (jlm, jproc), _ = pair
    return {
        "slots": _drive(JBatch(jlm, jproc, slots=3, window=256), PLAN),
        32: _drive(JPaged(jlm, jproc, slots=3, window=256, page_size=32), PLAN),
        128: _drive(JPaged(jlm, jproc, slots=3, window=256, page_size=128), PLAN),
    }


def test_slot_engine_matches_jax(pair, jax_streams):
    _, (tlm, tproc) = pair
    got = _drive(TBatch(tlm, tproc, slots=3, window=256), PLAN)
    assert got == jax_streams["slots"]
    assert all(len(t) > 4 for t in got)


@pytest.mark.parametrize("page", [32, 128])
def test_paged_engine_matches_jax(pair, jax_streams, page):
    _, (tlm, tproc) = pair
    eng = TPaged(tlm, tproc, slots=3, window=256, page_size=page)
    assert eng.state.k.shape == (2, eng.pool_pages + 1, 2, page, 32)
    assert _drive(eng, PLAN) == jax_streams[page]
    assert sorted(eng._free_pages) == list(range(eng.pool_pages))


def test_paged_preemption_resume_matches_jax(pair):
    """Two 64-token prompts need 2 pages each; growing past 64 and 96
    columns wants pages 3 and 4 per slot, so a 5-page pool preempts the
    younger request, which resumes by recompute and still emits the JAX
    engine's tokens (token-exact on the CPU in fp32)."""
    (jlm, jproc), (tlm, tproc) = pair
    plan = [(0, ["Preemption test request A."], 50), (0, ["Preemption test request B!"], 50)]
    jeng = JPaged(jlm, jproc, slots=2, window=128, page_size=32, pool_pages=5)
    teng = TPaged(tlm, tproc, slots=2, window=128, page_size=32, pool_pages=5)
    want, got = _drive(jeng, plan, chunk=1), _drive(teng, plan, chunk=1)
    assert teng.preemptions > 0
    assert got == want
    assert len(teng._free_pages) == teng.pool_pages


class ReplayJaxPool:
    """``paging.write_fresh`` for the port that writes the entries the JAX
    engine wrote at the same (layer, page, row) in the same chunk (``snap``,
    the JAX pool after that chunk) and counts where its own differ."""

    def __init__(self):
        self.snap, self.values, self.flips, self.max_step = None, 0, 0, 0

    def __call__(self, st, layer, pid, row, k, v):
        own_p, own_s = TS.quantize_chunk(k, v, st.kv_quant)
        own_p, own_s = own_p[:, :, 0], own_s[:, :, 0]
        want_p, want_s = (t[layer, pid, :, row] for t in self.snap)
        live = pid != st.k.shape[1] - 1  # the spare page takes inactive slots
        step = (torch.stack([own_p & 15, own_p >> 4]).int()
                - torch.stack([want_p & 15, want_p >> 4]).int()).abs()[:, live]
        self.values += step.numel()
        self.flips += int((step > 0).sum())
        self.max_step = max(self.max_step, int(step.max()))
        torch.testing.assert_close(own_s[live].float(), want_s[live].float(), rtol=2.0**-7,
                                   atol=1e-6)
        live4 = live[:, None, None]
        st.k[layer, pid, :, row] = torch.where(live4, want_p, own_p)
        st.k_scales[layer, pid, :, row] = torch.where(live4, want_s, own_s)

    def check(self):
        assert self.values > 0 and self.max_step <= 1
        assert self.flips <= MAX_FLIP_SHARE * self.values, (self.flips, self.values)


def test_paged_int4_pool_replays_jax(pair, monkeypatch):
    """The int4 pool (kernel K7's layout): both engines in lockstep; the
    port's prefills replay the JAX prefill's entries and its decode writes
    the JAX pool's entries, so the streams must be identical."""
    (jlm, jproc), (tlm, tproc) = pair
    from phi_3_vision_mlx_tpu.engine.engine import LM as JLM

    jlm = JLM(jlm.cfg.replace(use_quantized_cache=True), jlm.params)
    tlm = LM(tlm.cfg.replace(use_quantized_cache=True), tlm.params, device="cpu")
    jeng = JPaged(jlm, jproc, slots=3, window=256, page_size=64)
    teng = TPaged(tlm, tproc, slots=3, window=256, page_size=64)
    writer = ReplayJaxPool()
    monkeypatch.setattr(TP, "write_fresh", writer)
    prefills, jr, tr = [], [], []
    for step in range(12):
        if step in (0, 3):
            for prompt in PROMPTS[:2] if step == 0 else PROMPTS[2:]:
                jp = jeng.prepare(prompt, max_tokens=20)
                prefills.append(ReplayJaxCache(jp.src_state, 4))
                monkeypatch.setattr(TM, "update_layer_chunk", prefills[-1])
                tp = teng.prepare(prompt, max_tokens=20)
                jr.append(jeng.admit(jp))
                tr.append(teng.admit(tp))
        jeng.step(4)
        writer.snap = from_jax_paged_pool(np.asarray(jeng.state.pool_k),
                                          np.asarray(jeng.state.pool_v.astype(jnp.float32)),
                                          quantized=True)
        teng.step(4)
    assert not jeng.pending() and not teng.pending()
    assert [teng.tokens(r) for r in tr] == [jeng.tokens(r) for r in jr]
    writer.check()
    for replay in prefills:
        replay.check()


def test_int8_pool_matches_int8_slots(pair):
    """The int8 pool's route (the layer's pool dequantized, then K6's plain
    version) gives the int8 slot engine's streams: both quantize with the
    same code and attend over the same values."""
    from phi_3_vision_mlx_tpu_torch.core.config import KVQuantConfig

    _, (tlm, tproc) = pair
    lm8 = LM(tlm.cfg.replace(use_quantized_cache=True, kv_quant=KVQuantConfig(bits=8)),
             tlm.params, device="cpu")
    paged = TPaged(lm8, tproc, slots=3, window=256, page_size=64)
    assert paged.state.k.shape[-1] == 2 * 32 and paged.state.k.dtype == torch.uint8
    want = _drive(TBatch(lm8, tproc, slots=3, window=256), PLAN)
    assert _drive(paged, PLAN) == want


@pytest.mark.parametrize("paged", [False, True], ids=["slots", "paged"])
def test_prepare_many_matches_one_at_a_time(pair, paged):
    _, (tlm, tproc) = pair
    make = (lambda: TPaged(tlm, tproc, slots=3, window=256, page_size=64)) if paged else (
        lambda: TBatch(tlm, tproc, slots=3, window=256))
    one = make()
    rids = [one.submit(p, max_tokens=10) for p in PROMPTS]
    while one.pending():
        one.step(2)
    eng = make()
    prepared = eng.prepare_many(PROMPTS, [dict(max_tokens=10)] * 3)
    assert [p.src_row for p in prepared] == [0, 1, 2]
    assert prepared[0].src_state is prepared[2].src_state
    rids2 = [eng.admit(p) for p in prepared]
    while eng.pending():
        eng.step(2)
    assert [eng.tokens(r) for r in rids2] == [one.tokens(r) for r in rids]


@pytest.mark.parametrize("depth", [1, 2])
def test_step_pipelined_matches_step(pair, depth):
    """Pipelined ticks (depth chunks in flight, mid-run admission, a pool
    that preempts) give the synchronous path's streams."""
    _, (tlm, tproc) = pair
    plan = [(0, ["Preempt pressure one two three."], 24),
            (1, ["Second request under pressure."], 24)]

    def make():
        return TPaged(tlm, tproc, slots=2, window=256, page_size=32, pool_pages=5,
                      pipeline_depth=depth)

    sync = _drive(make(), plan)
    eng = make()
    assert _drive(eng, plan, pipelined=True) == sync
    assert sorted(eng._free_pages) == list(range(eng.pool_pages))


def test_lone_request_on_a_small_pool_fails_cleanly(pair):
    _, (tlm, tproc) = pair
    eng = TPaged(tlm, tproc, slots=1, window=128, page_size=32, pool_pages=2)
    rid = eng.submit("Lone request on a starved pool.", max_tokens=80)
    for _ in range(200):
        if not eng.pending():
            break
        eng.step()
    assert eng.requests[rid].done and "pool too small" in eng.requests[rid].error
    with pytest.raises(RuntimeError, match="pool too small"):
        eng.result(rid)
    assert len(eng._free_pages) == eng.pool_pages
    big = TPaged(tlm, tproc, slots=1, window=256, page_size=64, pool_pages=1)
    prepared = big.prepare("word " * 20, max_tokens=8)  # two pages
    with pytest.raises(ValueError, match="pool"):
        big.can_admit(prepared)
    with pytest.raises(RuntimeError, match="exhausted"):
        big.admit(prepared)
    assert big._free_pages == [0] and big.free == [0]


def test_unported_options_raise(pair):
    _, (tlm, tproc) = pair
    eng = TPaged(tlm, tproc, slots=1, window=128)
    with pytest.raises(NotImplementedError, match="sampling"):
        eng.prepare("x", temperature=0.5)
    with pytest.raises(ValueError, match="never batched"):
        eng.prepare_many(["x", "y"], [dict(images=["a.png"]), {}])
    with pytest.raises(NotImplementedError, match="spec_k"):
        TBatch(tlm, tproc, spec_k=2)


def _post(port, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/completions",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=300) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_continuous_server_matches_jax_server(pair):
    """Four threads post at once to each continuous server (paged, 3 slots,
    a pool that preempts); every response equals the JAX server's."""
    continuous_servers_agree(pair)


def continuous_servers_agree(pair):
    """Post the same bodies to the JAX and the port's continuous servers
    over ``pair`` from concurrent threads; the responses must be equal."""
    (jlm, jproc), (tlm, tproc) = pair
    kw = dict(slots=3, window=128, paged=True, page_size=32, pool_pages=8)
    servers = [
        ThreadingHTTPServer(("127.0.0.1", 0), JS.make_continuous_handler(
            JS.ContinuousScheduler(jlm, jproc, **kw))),
        ThreadingHTTPServer(("127.0.0.1", 0), TSV.make_continuous_handler(
            TSV.ContinuousScheduler(tlm, tproc, **kw))),
    ]
    threads = [threading.Thread(target=s.serve_forever, daemon=True) for s in servers]
    for t in threads:
        t.start()
    try:
        bodies = [{"prompt": f"Saturation request number {i}.", "max_tokens": 30} for i in range(4)]
        bodies.append({"prompt": ["Two prompts", "in one body"], "max_tokens": 8, "stop": ">"})
        results = {}

        def worker(i, port, body):
            results[i, port] = _post(port, body)

        posts = [threading.Thread(target=worker, args=(i, s.server_address[1], b))
                 for s in servers for i, b in enumerate(bodies)]
        for t in posts:
            t.start()
        for t in posts:
            t.join(timeout=300)
        jport, tport = (s.server_address[1] for s in servers)
        for i in range(len(bodies)):
            assert results[i, tport] == results[i, jport]
            assert results[i, tport][0] == 200
        code, payload = _post(tport, {"prompt": "x", "temperature": 0.7})
        assert code == 500 and "sampling" in payload["error"]
        code, payload = _post(tport, {"prompt": "x", "stop": ""})
        assert code == 400
    finally:
        for s in servers:
            s.shutdown()
            s.server_close()
        for t in threads:
            t.join(timeout=30)
