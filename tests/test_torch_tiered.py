"""The port's tiered KV cache (``engine/tiered.py``) against the JAX
``TieredEngine`` and against the port's own in-HBM int4 path.

The cases mirror ``tests/test_tiered.py``: one JAX-written fp32 tiny
checkpoint (unquantized weights) loaded by both packages with the int4
cache, ``chunk=64``, ``hot=64``, ``k_block=32``, prompts of random ids from
``np.random.default_rng``.  On the CPU the cold tier is plain host memory
and the attention dots run in f32 (``PHI3V_TPU_TIERED_BF16`` unset).

Tolerances: against the port's in-HBM path (the same quantization code, the
same cache entries) f32 logits within 3e-4, the measured difference being
about 2e-6, and greedy tokens equal.  Against the JAX engine the port's
entries replay the JAX engine's cold and hot entries (a 1e-7 f32 difference
in a key can round it to the neighbouring int4 level, which moved these
logits by 9e-4 without the replay); with them the logits agree within
``FP32_ATOL`` (1e-4).  The bf16-dots mode (``PHI3V_TPU_TIERED_BF16=1``,
the card's default) trades precision by design, 0.15 absolute on O(1)
logits against the f32 mode, as in the JAX test; against the JAX engine's
own bf16 mode, with its entries replayed, the logits agree within
``BF16_ATOL`` (2e-3): over seeds 0, 5, 7 and 21 (prefill and 4 steps each)
the largest difference measured was 1.02e-3 (one step of seed 21, a bf16
rounding of one weight landing the other way), the rest at most 3.1e-6,
where the bf16 mode sits 5.2e-2 to 8.3e-2 from the f32 one.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402,F401

from test_torch_model import FP32_ATOL, ReplayJaxCache  # noqa: E402
from phi_3_vision_mlx_tpu.api import _load as jax_load  # noqa: E402
from phi_3_vision_mlx_tpu.core import weights as JW  # noqa: E402
from phi_3_vision_mlx_tpu.engine.tiered import TieredEngine as JaxTiered  # noqa: E402
from phi_3_vision_mlx_tpu_torch.api import _load as torch_load  # noqa: E402
from phi_3_vision_mlx_tpu_torch.core.convert import from_jax_kv_cache  # noqa: E402
from phi_3_vision_mlx_tpu_torch.engine import state as TS  # noqa: E402
from phi_3_vision_mlx_tpu_torch.engine import tiered as TT  # noqa: E402
from phi_3_vision_mlx_tpu_torch.models import phi3 as TM  # noqa: E402
from test_torch_model import one_thread  # noqa: E402,F401  (autouse: one torch thread)

PC, HOT, KB = 64, 64, 32
VOCAB = 512  # the tiny preset's
HBM_ATOL = 3e-4
BF16_ATOL = 2e-3


@pytest.fixture(scope="module")
def path(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("tiered") / "tiny")
    JW.create_random_checkpoint(p, "tiny")
    return p


@pytest.fixture(scope="module")
def tlm(path):
    return torch_load(path, device="cpu", use_quantized_cache=True)[0]


@pytest.fixture(scope="module")
def jlm(path):
    return jax_load(path, use_quantized_cache=True)[0]


@pytest.fixture(scope="module")
def eng(tlm):
    """One engine serves the module: a request's state is its own."""
    return TT.TieredEngine(tlm, chunk=PC, hot=HOT, k_block=KB)


def _ids(seed: int, n: int):
    return {"input_ids": np.random.default_rng(seed).integers(2, VOCAB, (1, n)).astype(np.int32)}


def _repetitive(seed: int, period: int):
    pattern = np.random.default_rng(seed).integers(2, VOCAB, period).astype(np.int32)
    return {"input_ids": np.tile(pattern, 140 // period + 1)[None, :130]}


def _in_hbm(tlm, dict_input, n_steps: int):
    """The port's in-HBM int4 path over the window the tiered engine uses:
    prefill of the chunk-padded prompt, then greedy ``decode_forward``
    steps.  Returns (tokens, logits per step)."""
    ids_p, pids_p, valid_p, _ = TT._pad_to_chunks(dict_input, PC)
    res = TM.prefill(tlm.params, tlm.cfg, torch.as_tensor(ids_p, dtype=torch.long), max_tokens=HOT,
                     pids=torch.as_tensor(pids_p), prompt_valid=torch.as_tensor(valid_p),
                     last_logit_only=True)
    logits, state = res.logits[:, -1].float().numpy(), res.state
    toks, logs = [int(np.argmax(logits[0]))], [logits]
    for _ in range(n_steps):
        res = TM.decode_forward(tlm.params, tlm.cfg, state, torch.tensor([[toks[-1]]]))
        state, logits = res.state, res.logits[:, -1].float().numpy()
        toks.append(int(np.argmax(logits[0])))
        logs.append(logits)
    return toks, logs


def _step_all(eng, state, tok, n_steps):
    toks, logs = [], []
    for _ in range(n_steps):
        logits, state = eng.decode_step(state, np.array([[tok]]))
        logits = logits.numpy()
        tok = int(np.argmax(logits[0]))
        toks.append(tok)
        logs.append(logits)
    return toks, logs, state


class ReplayJaxCold:
    """``quantize_chunk`` for the port's tiered prefill that returns the JAX
    engine's evicted entries of each (chunk, layer), in call order, after
    checking that its own differ from them by at most one level."""

    def __init__(self, jax_state, n_layers: int):
        self.chunks = [from_jax_kv_cache(np.asarray(k), np.asarray(s.astype(np.float32)))
                       for k, s in zip(jax_state.cold_k, jax_state.cold_s)]
        self.n_layers, self.calls = n_layers, 0

    def __call__(self, k_new, v_new, kvq):
        c, i = divmod(self.calls, self.n_layers)
        self.calls += 1
        payload, scales = (t[i] for t in self.chunks[c])
        own_p, own_s = TS.quantize_chunk(k_new, v_new, kvq)
        for shift in (0, 4):
            step = (((own_p >> shift) & 15).int() - ((payload >> shift) & 15).int()).abs()
            assert int(step.max()) <= 1
        torch.testing.assert_close(own_s.float(), scales.float(), rtol=2.0**-7, atol=1e-6)
        return payload, scales


def _jax_steps(jlm, dict_input, n_steps):
    """The JAX engine's prefill and ``n_steps`` greedy steps: (tokens,
    logits per step, state)."""
    jeng = JaxTiered(jlm, chunk=PC, hot=HOT, k_block=KB, prefetch=False)
    jl, jstate = jeng.prefill(dict_input)
    jtoks, jlogs = [int(np.argmax(jl[0]))], [jl]
    for _ in range(n_steps):
        lg, jstate = jeng.decode_step(jstate, np.array([[jtoks[-1]]], np.int32))
        jlogs.append(np.asarray(lg, np.float32))
        jtoks.append(int(np.argmax(jlogs[-1][0])))
    return jtoks, jlogs, jstate


def test_tiered_matches_jax_engine_and_in_hbm_path(tlm, jlm, eng, monkeypatch):
    """3 cold chunks + 4 hot decode steps: the prefill and step logits equal
    the JAX engine's (its entries replayed) and the port's in-HBM path's,
    greedy tokens identical; the cold tier holds 3 chunks of host memory."""
    dict_input, n_steps = _ids(0, 150), 4
    ref_toks, ref_logs = _in_hbm(tlm, dict_input, n_steps)

    jtoks, jlogs, jstate = _jax_steps(jlm, dict_input, n_steps)
    jl = jlogs[0]
    cold = ReplayJaxCold(jstate, tlm.cfg.num_hidden_layers)
    hot = ReplayJaxCache(jstate.hot, 4)
    monkeypatch.setattr(TT, "quantize_chunk", cold)
    monkeypatch.setattr(TT, "update_layer_chunk", hot)

    logits, state = eng.prefill(dict_input)
    assert len(state.cold_k) == 3 and state.C == 192 and state.window == 256
    assert state.cold_k[0].device.type == "cpu" and state.cold_k[0].shape[3] == PC
    assert cold.calls == 3 * tlm.cfg.num_hidden_layers
    np.testing.assert_allclose(logits, jl, rtol=0, atol=FP32_ATOL)
    toks, logs, _ = _step_all(eng, state, int(np.argmax(logits[0])), n_steps)
    toks = [int(np.argmax(logits[0]))] + toks
    for got, want in zip(logs, jlogs[1:]):
        np.testing.assert_allclose(got, want, rtol=0, atol=FP32_ATOL)
    hot.check()
    assert toks == jtoks == ref_toks

    monkeypatch.undo()  # the port's own entries: the in-HBM path's
    logits, state = eng.prefill(dict_input)
    np.testing.assert_allclose(logits, ref_logs[0], rtol=0, atol=HBM_ATOL)
    _, logs, _ = _step_all(eng, state, ref_toks[0], n_steps)
    for got, want in zip(logs, ref_logs[1:]):
        np.testing.assert_allclose(got, want, rtol=0, atol=HBM_ATOL)


def test_tiered_generate_short_prompt(tlm, jlm, eng):
    """A prompt shorter than one chunk (one cold chunk, left pads masked)
    generates the in-HBM path's tokens and the JAX engine's."""
    dict_input = _ids(1, 20)
    ref_toks, _ = _in_hbm(tlm, dict_input, 5)
    toks = eng.generate(dict_input, max_tokens=6)
    assert toks == ref_toks[:6]
    assert toks == JaxTiered(jlm, chunk=PC, hot=HOT, k_block=KB).generate(dict_input, max_tokens=6)


def test_tiered_rejects_overlong_decode(tlm):
    eng = TT.TieredEngine(tlm, chunk=PC, hot=8)
    with pytest.raises(ValueError, match="hot window"):
        eng.generate({"input_ids": np.array([[3, 4, 5]])}, max_tokens=64)
    with pytest.raises(ValueError, match="hot window"):
        eng.spec_generate({"input_ids": np.array([[3, 4, 5]])}, max_tokens=4, k_draft=7)
    _, state = eng.prefill({"input_ids": np.array([[3, 4, 5]])})
    with pytest.raises(ValueError, match="overflow"):
        eng.decode_chunk(state, np.array([[3]]), 9)


@pytest.mark.parametrize("kind", ["repetitive", "random"])
def test_tiered_spec_decode_matches_per_step(tlm, eng, kind):
    """``spec_generate`` (prompt-lookup drafts verified in one Lq = K + 1
    pass over the cold tier) emits the per-step greedy stream: a repetitive
    prompt accepts drafts, a random one rejects them."""
    dict_input = _repetitive(3, 12) if kind == "repetitive" else _ids(3, 90)
    ref_toks, _ = _in_hbm(tlm, dict_input, 9)
    toks = eng.spec_generate(dict_input, max_tokens=10, k_draft=3, n_iters=3)
    assert toks == ref_toks[:10]


def test_tiered_no_prefetch_matches(tlm):
    """``prefetch=False`` (each layer's copy on the compute stream; on the
    CPU nothing is copied) emits the same greedy stream."""
    dict_input = _ids(5, 150)
    ref_toks, _ = _in_hbm(tlm, dict_input, 5)
    eng = TT.TieredEngine(tlm, chunk=PC, hot=HOT, k_block=KB, prefetch=False)
    assert not eng.prefetch
    assert eng.generate(dict_input, max_tokens=6) == ref_toks[:6]


@pytest.mark.parametrize("group", [2, 4])
def test_tiered_consolidate_matches(tlm, eng, group):
    """Merging cold chunks (fewer, larger host-to-device copies) leaves the
    logits and greedy tokens as they were: the stats loop sees the same
    columns in the same order."""
    dict_input = _ids(4, 250)  # 4 chunks
    ref_toks, ref_logs = _in_hbm(tlm, dict_input, 3)
    logits, state = eng.prefill(dict_input)
    assert len(state.cold_k) == 4
    state = eng.consolidate(state, group)
    assert len(state.cold_k) == 4 // group and state.C == 256 and state.PC == group * PC
    assert state.cold_k[0].shape[3] == group * PC and state.cold_s[0].shape[3] == group * PC
    toks, logs, _ = _step_all(eng, state, int(np.argmax(logits[0])), 3)
    for got, want in zip(logs, ref_logs[1:]):
        np.testing.assert_allclose(got, want, rtol=0, atol=HBM_ATOL)
    assert [int(np.argmax(logits[0]))] + toks == ref_toks
    with pytest.raises(ValueError, match="do not group"):
        eng.consolidate(eng.prefill(_ids(4, 150))[1], 2)


def test_tiered_chunked_decode_matches_per_step(tlm, jlm, eng):
    """``decode_chunk`` (several steps a host fetch, the token fed back on
    the device) emits the per-step stream, the in-HBM path's and the JAX
    engine's."""
    dict_input = _ids(2, 100)
    ref_toks, _ = _in_hbm(tlm, dict_input, 7)
    toks = eng.generate(dict_input, max_tokens=8, chunk_steps=3)
    assert toks == ref_toks[:8]
    jeng = JaxTiered(jlm, chunk=PC, hot=HOT, k_block=KB)
    assert toks == jeng.generate(dict_input, max_tokens=8, chunk_steps=3)


def test_tiered_spec_sampling_composes(tlm, eng):
    """Speculation with sampling (rejection-sampled verification): at
    temperature 1e-5 it is the greedy stream; at temperature 1 it emits the
    whole budget, repeats under one seed and differs across seeds.  The
    noise comes from ``engine/rng.py``, so its draws are not JAX's."""
    dict_input = _repetitive(11, 10)
    ref_toks, _ = _in_hbm(tlm, dict_input, 9)
    cold = eng.spec_generate(dict_input, max_tokens=10, k_draft=3, n_iters=3, temperature=1e-5,
                             seed=0)
    assert cold == ref_toks[:10]
    kw = dict(max_tokens=10, k_draft=3, n_iters=3, temperature=1.0, top_p=0.9)
    warm1, warm2, warm3 = (eng.spec_generate(dict_input, seed=s, **kw) for s in (7, 7, 8))
    assert warm1 == warm2 and len(warm1) == 10
    assert all(0 <= t < VOCAB for t in warm1)
    assert warm1 != warm3


def test_tiered_bf16_dots_mode(tlm, monkeypatch):
    """``PHI3V_TPU_TIERED_BF16=1`` (the card's default) runs the attention
    dots on bf16 inputs with f32 sums: the logits move (the knob engages),
    stay within the traded precision of the f32 mode, and keep the argmax."""
    dict_input = _ids(21, 100)

    def run():
        eng = TT.TieredEngine(tlm, chunk=PC, hot=HOT, k_block=KB)
        logits, state = eng.prefill(dict_input)
        step, _ = eng.decode_step(state, np.array([[int(np.argmax(logits[0]))]]))
        return logits, step.numpy()

    monkeypatch.setenv("PHI3V_TPU_TIERED_BF16", "0")
    p0, d0 = run()
    monkeypatch.setenv("PHI3V_TPU_TIERED_BF16", "1")
    p1, d1 = run()
    assert not np.array_equal(p0, p1)
    np.testing.assert_allclose(p1, p0, rtol=0, atol=0.15)
    np.testing.assert_allclose(d1, d0, rtol=0, atol=0.15)
    assert np.argmax(p1[0]) == np.argmax(p0[0]) and np.argmax(d1[0]) == np.argmax(d0[0])
    monkeypatch.delenv("PHI3V_TPU_TIERED_BF16")
    assert not TT._bf16_dots("cpu") and TT._bf16_dots("cuda")


@pytest.mark.parametrize("seed", [0, 21])
def test_tiered_bf16_dots_mode_matches_jax_engine(tlm, jlm, monkeypatch, seed):
    """The bf16-dots mode of both packages (``PHI3V_TPU_TIERED_BF16=1``, the
    name both read): with the JAX engine's cold and hot entries replayed,
    the port's prefill and step logits equal its within ``BF16_ATOL``, and
    the greedy tokens are its.  The port takes the JAX form: bf16 queries
    and keys, the f32 products scaled, block weights exp(s - m) with the
    scan's running max, rounded to bf16 for the product with v."""
    monkeypatch.setenv("PHI3V_TPU_TIERED_BF16", "1")
    dict_input, n_steps = _ids(seed, 150), 4
    jtoks, jlogs, jstate = _jax_steps(jlm, dict_input, n_steps)
    hot = ReplayJaxCache(jstate.hot, 4)
    monkeypatch.setattr(TT, "quantize_chunk", ReplayJaxCold(jstate, tlm.cfg.num_hidden_layers))
    monkeypatch.setattr(TT, "update_layer_chunk", hot)
    eng = TT.TieredEngine(tlm, chunk=PC, hot=HOT, k_block=KB)
    logits, state = eng.prefill(dict_input)
    toks, logs, _ = _step_all(eng, state, jtoks[0], n_steps)
    for got, want in zip([logits] + logs, jlogs):
        np.testing.assert_allclose(got, want, rtol=0, atol=BF16_ATOL)
    hot.check()
    assert [int(np.argmax(logits[0]))] + toks == jtoks


def test_bf16_dot_sums_rounded_inputs_in_f32():
    """``_dot``'s bf16 branch, whose batching (broadcast leading dims, one
    ``bmm``) the card shares, its last product aside: the inputs rounded to
    bf16, their products summed in f32, the leading dims broadcast as
    ``matmul`` broadcasts them."""
    rng = np.random.default_rng(4)
    a = torch.as_tensor(rng.standard_normal((1, 3, 2, 5, 40)), dtype=torch.float32)
    b = torch.as_tensor(rng.standard_normal((1, 3, 1, 40, 7)), dtype=torch.float32)
    got = TT._dot(a, b, True)
    want = torch.matmul(a.bfloat16().double(), b.bfloat16().double())
    assert got.dtype == torch.float32 and got.shape == (1, 3, 2, 5, 7)
    torch.testing.assert_close(got.double(), want, rtol=0, atol=1e-5)
    assert not torch.allclose(got, torch.matmul(a, b), rtol=0, atol=1e-5)
