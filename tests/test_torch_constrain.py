"""The port's constrained decoding (``engine/constrain.py``), its model read
paths (``phi3.forward_nocache``, ``decode_forward(n_beam=)``) and the
``api.choose`` / ``api.constrain`` entry points, against the JAX package and
``tests/reference_numpy.RefModel`` on the CPU in fp32.

The contract: equal strings and chosen letters, and every device step's
log-probs (the prefill's, ``score_fn``'s, ``beam_fn``'s, ``nocache_fn``'s)
within ``STEP_ATOL`` of the JAX package's.  With a quantized cache (int8,
int4) the port writes the JAX package's quantized entries, step by step
(``ReplayJaxSteps``; tests/test_torch_model.py:ReplayJaxCache says why): a
score step writes the constraint's columns without committing them, and
the next step overwrites them, so each step replays the JAX cache as that
step left it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import reference_numpy as ref  # noqa: E402
from test_parity_reference import _cfg_dict, _ref_weights  # noqa: E402
from test_torch_model import ReplayJaxCache, make_checkpoint  # noqa: E402
from test_torch_speculative import one_thread  # noqa: E402,F401  (autouse: one torch thread)

from phi_3_vision_mlx_tpu import api as JAPI  # noqa: E402
from phi_3_vision_mlx_tpu.api import _load as jax_load  # noqa: E402
from phi_3_vision_mlx_tpu.core.config import KVQuantConfig  # noqa: E402
from phi_3_vision_mlx_tpu.core.config import preset as jax_preset  # noqa: E402
from phi_3_vision_mlx_tpu.engine import constrain as JC  # noqa: E402
from phi_3_vision_mlx_tpu.engine import engine as JE  # noqa: E402
from phi_3_vision_mlx_tpu.models import phi3 as JM  # noqa: E402
from phi_3_vision_mlx_tpu_torch import api as TAPI  # noqa: E402
from phi_3_vision_mlx_tpu_torch.api import _load as torch_load  # noqa: E402
from phi_3_vision_mlx_tpu_torch.core.config import preset as torch_preset  # noqa: E402
from phi_3_vision_mlx_tpu_torch.core.convert import from_numpy_params  # noqa: E402
from phi_3_vision_mlx_tpu_torch.engine import constrain as TC  # noqa: E402
from phi_3_vision_mlx_tpu_torch.engine import engine as TE  # noqa: E402
from phi_3_vision_mlx_tpu_torch.models import phi3 as TM  # noqa: E402


# fp32 log-probs of O(10): both sides run the same f32 math, summed in
# another order.
STEP_ATOL = 1e-5
LOGIT_ATOL = 1e-4
QUESTION = "<|user|>\nWhich planet is the largest? A: Mars B: Jupiter<|end|>\n<|assistant|>\n"
PROMPTS = ["Hi", "Which one is it, the first or the second?", "Pick a letter."]


# -- the model's read paths against JAX and the NumPy reference ------------------

# The reference's manual attention has no GQA path: four kv heads.
REF_OVERRIDES = dict(num_key_value_heads=4, dtype="float32")


@pytest.fixture(scope="module")
def ref_setup():
    jcfg = jax_preset("tiny", **REF_OVERRIDES)
    params = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = torch_preset("tiny", **REF_OVERRIDES)
    tparams = from_numpy_params(jax.tree_util.tree_map(np.asarray, params), tcfg)
    return (jcfg, params), (tcfg, tparams), (_cfg_dict(jcfg), _ref_weights(params, jcfg))


def _left_padded(rng, vocab, pads, l):
    ids = rng.integers(2, vocab, (len(pads), l)).astype(np.int32)
    pids = np.stack([np.concatenate([np.ones(p, np.int32), np.arange(l - p, dtype=np.int32)])
                     for p in pads])
    mask = np.stack([np.concatenate([np.zeros(p, np.int32), np.ones(l - p, np.int32)]) for p in pads])
    return ids * mask, pids, mask


@pytest.mark.parametrize("allow_flash", [True, False], ids=["flash", "masked"])
def test_forward_nocache_matches_jax_and_reference(ref_setup, allow_flash):
    (jcfg, jparams), (tcfg, tparams), (cfg_d, weights) = ref_setup
    ids, pids, mask = _left_padded(np.random.default_rng(0), jcfg.vocab_size, [3, 0, 5], 12)
    want = np.asarray(JM.forward_nocache(jparams, jcfg, jnp.asarray(ids), pids=jnp.asarray(pids),
                                         prompt_valid=jnp.asarray(mask.astype(bool))))
    got = TM.forward_nocache(tparams, tcfg, torch.as_tensor(ids).long(), pids=torch.as_tensor(pids),
                             prompt_valid=torch.as_tensor(mask.astype(bool)),
                             allow_flash=allow_flash).numpy()
    assert got.shape == want.shape == (3, 12, jcfg.vocab_size)
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_ATOL)
    theirs = ref.RefModel(cfg_d, weights)(ids, max_tokens=0, pids=pids, mask=mask)
    valid_rows = mask.astype(bool)  # a pad query's row is masked differently by the reference
    np.testing.assert_allclose(got[valid_rows], theirs[valid_rows], rtol=2e-4, atol=2e-4)
    # LoRA dropout (refused here until LoRA was ported) drops only LoRA
    # branches' inputs: on a tree without LoRA leaves, with or without a
    # key, the logits are the same, as in the JAX package.
    for kw in (dict(lora_dropout=0.1), dict(lora_dropout=0.1, dropout_rng=(1, 0))):
        again = TM.forward_nocache(tparams, tcfg, torch.as_tensor(ids).long(), pids=torch.as_tensor(pids),
                                   prompt_valid=torch.as_tensor(mask.astype(bool)), allow_flash=allow_flash, **kw)
        np.testing.assert_array_equal(again.numpy(), got)


@pytest.mark.parametrize("rows", [1, 2])
def test_beam_read_path_matches_jax_and_reference(ref_setup, rows):
    """``decode_forward(n_beam=3)`` scores a (B * 3, L) chunk against the
    shared cache and writes nothing (JAX beam path; the reference's KVCache
    beam mode, whose tables hold one cache row)."""
    (jcfg, jparams), (tcfg, tparams), (cfg_d, weights) = ref_setup
    rng = np.random.default_rng(4)
    ids = rng.integers(2, jcfg.vocab_size, (rows, 8)).astype(np.int32)
    beams = rng.integers(2, jcfg.vocab_size, (3 * rows, 5)).astype(np.int32)
    jres = JM.prefill(jparams, jcfg, jnp.asarray(ids), max_tokens=10)
    want = np.asarray(JM.decode_forward(jparams, jcfg, jres.state, input_ids=jnp.asarray(beams),
                                        n_beam=3).logits)
    tres = TM.prefill(tparams, tcfg, torch.as_tensor(ids).long(), max_tokens=10)
    k_before = tres.state.k.clone()
    out = TM.decode_forward(tparams, tcfg, tres.state, torch.as_tensor(beams).long(), n_beam=3)
    assert out.state is tres.state and int(tres.state.pos) == 8 and torch.equal(tres.state.k, k_before)
    np.testing.assert_allclose(out.logits.numpy(), want, rtol=0, atol=LOGIT_ATOL)
    if rows == 1:
        model = ref.RefModel(cfg_d, weights)
        model(ids, max_tokens=10)
        np.testing.assert_allclose(out.logits.numpy(), model(beams, n_beam=3), rtol=2e-4, atol=2e-4)


def test_beam_read_masks_uncommitted_columns(ref_setup):
    """A score step with ``advance=0`` leaves the constraint's k/v past the
    offset; the beam read must not see them."""
    _, (tcfg, tparams), _ = ref_setup
    ids = torch.as_tensor(np.random.default_rng(5).integers(2, 500, (1, 6))).long()
    beams = torch.tensor([[7, 8, 9], [10, 8, 9], [11, 8, 9]])
    state = TM.prefill(tparams, tcfg, ids, max_tokens=8).state
    clean = TM.decode_forward(tparams, tcfg, state, beams, n_beam=3).logits
    state = TM.decode_forward(tparams, tcfg, state, torch.tensor([[40, 41, 42, 43]]), advance=0).state
    assert state.offset == 6
    torch.testing.assert_close(TM.decode_forward(tparams, tcfg, state, beams, n_beam=3).logits, clean,
                               rtol=0, atol=0)


# -- choose_from and constrain_decode through both packages ------------------------


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return make_checkpoint(tmp_path_factory.mktemp("ckpt"), "tiny")


@pytest.fixture(scope="module")
def pair(ckpt):
    return jax_load(ckpt), torch_load(ckpt, device="cpu")


class StepLog:
    """Wraps an LM's ``score_fn``, ``beam_fn`` and ``nocache_fn`` (and the
    module's ``run_prefill``) to keep every step's log-probs, as numpy, in
    call order; JAX's also keep the cache each writing step left
    (``snapshots``), copied before the next step donates it."""

    def __init__(self, lm, engine_module, monkeypatch):
        self.steps, self.snapshots = [], []
        is_jax = isinstance(lm, JE.LM)

        def keep(lp, state=None):
            self.steps.append(np.array(lp))
            if is_jax and state is not None and state.kv.quantized:
                self.snapshots.append(_snapshot(state))

        def wrap(make, writes):
            def maker(*a, **kw):
                fn = make(*a, **kw)

                def f(*args):
                    out = fn(*args)
                    keep(*out) if writes else keep(out)
                    return out

                return f

            return maker

        monkeypatch.setattr(lm, "score_fn", wrap(lm.score_fn, True))
        monkeypatch.setattr(lm, "beam_fn", wrap(lm.beam_fn, False))
        monkeypatch.setattr(lm, "nocache_fn", wrap(lm.nocache_fn, False))
        run_prefill = engine_module.run_prefill

        def prefill(lm_, *a, **kw):
            out = run_prefill(lm_, *a, **kw)
            keep(out[0], out[1])
            return out

        monkeypatch.setattr(engine_module, "run_prefill", prefill)  # the port's prefill_entry calls it


def _snapshot(state):
    """A copy of a JAX state's quantized cache that outlives donation."""
    kv = state.kv
    return kv._replace(k=np.array(kv.k), k_scales=np.array(kv.k_scales.astype(jnp.float32)))


class ReplayJaxSteps:
    """The port's ``update_layer_chunk`` replaying, for its n-th writing
    forward pass, the entries the JAX package's n-th writing step left
    (``ReplayJaxCache`` on each snapshot in turn)."""

    def __init__(self, snapshots, bits: int, n_layers: int):
        self.replays = [ReplayJaxCache(_Holder(kv), bits) for kv in snapshots]
        self.n_layers, self.calls = n_layers, 0

    def __call__(self, state, layer, pos, k_new, v_new):
        self.replays[self.calls // self.n_layers](state, layer, pos, k_new, v_new)
        self.calls += 1

    def check(self):
        assert self.calls == self.n_layers * len(self.replays)
        for r in self.replays:
            assert r.max_step <= 1
        flips = sum(r.flips for r in self.replays)
        values = sum(r.values for r in self.replays)
        assert values > 0 and flips <= 1e-3 * values, (flips, values)


class _Holder:
    def __init__(self, kv):
        self.kv = kv


def _with_cache(pair, bits):
    """The pair with the dense cache (``bits`` None) or a quantized one."""
    if bits is None:
        return pair
    (jlm, jproc), (tlm, tproc) = pair
    kvq = KVQuantConfig(bits=bits)
    jcfg = jlm.cfg.replace(use_quantized_cache=True, kv_quant=kvq)
    tcfg = tlm.cfg.replace(use_quantized_cache=True, kv_quant=kvq)
    return (JE.LM(jcfg, jlm.params), jproc), (TE.LM(tcfg, tlm.params, device="cpu"), tproc)


def _run_both(pair, monkeypatch, call):
    """``call(lm, proc, module)`` on the JAX side, then on the port's with
    the JAX cache replayed; returns (JAX result, port result, JAX steps,
    port steps)."""
    (jlm, jproc), (tlm, tproc) = pair
    jlog = StepLog(jlm, JE, monkeypatch)
    want = call(jlm, jproc, JC)
    replay = None
    if tlm.cfg.use_quantized_cache:
        replay = ReplayJaxSteps(jlog.snapshots, tlm.cfg.kv_quant.bits, tlm.cfg.num_hidden_layers)
        monkeypatch.setattr(TM, "update_layer_chunk", replay)
    tlog = StepLog(tlm, TE, monkeypatch)
    got = call(tlm, tproc, TC)
    if replay is not None:
        replay.check()
    return want, got, jlog.steps, tlog.steps


def _assert_steps(jsteps, tsteps):
    assert len(tsteps) == len(jsteps) > 0
    for i, (j, t) in enumerate(zip(jsteps, tsteps)):
        assert t.shape == j.shape, (i, t.shape, j.shape)
        np.testing.assert_allclose(t, j, rtol=0, atol=STEP_ATOL, err_msg=f"step {i}")


@pytest.mark.parametrize("prompt", [QUESTION, PROMPTS], ids=["B1", "B3"])
def test_choose_from_matches_jax(pair, monkeypatch, prompt):
    want, got, jsteps, tsteps = _run_both(
        pair, monkeypatch, lambda lm, proc, mod: mod.choose_from(lm, proc, prompt, "ABCDE", mute=True))
    assert got == want
    _assert_steps(jsteps, tsteps)


@pytest.mark.parametrize("bits", [None, 8, 4], ids=["dense", "int8", "int4"])
@pytest.mark.parametrize("use_beam,log_norm", [(False, False), (True, False), (True, True)],
                         ids=["greedy", "beam", "beam-lognorm"])
def test_constrain_decode_matches_jax(pair, monkeypatch, bits, use_beam, log_norm):
    """Two prompts of unequal length (left padding), a short and a long
    constraint, then a choice; every step's log-probs within STEP_ATOL."""
    constraints = [(3, " A"), (4, " The correct answer is"), "AB"]

    def call(lm, proc, mod):
        return mod.constrain_decode(lm, proc, [QUESTION, "<|user|>\nPick.<|end|>\n<|assistant|>\n"],
                                    constraints, mute=True, use_beam=use_beam, verbose=False,
                                    log_norm=log_norm)

    want, got, jsteps, tsteps = _run_both(_with_cache(pair, bits), monkeypatch, call)
    assert got == want and all(len(s) > 0 for s in got)
    _assert_steps(jsteps, tsteps)


@pytest.mark.parametrize("bits", [None, 8, 4], ids=["dense", "int8", "int4"])
def test_long_score_step_takes_the_decode_route(pair, monkeypatch, bits):
    """A score step of 1 + 22 rows (the JAX defaults' long constraint), with
    ``advance`` 0 and then 1, runs the decode route (K3/K4 in launches of 16
    rows at the device offset, never K2/K5) and gives the JAX ``score_fn``'s
    log-probs within STEP_ATOL; the quantized caches replay the JAX
    package's entries."""
    routes = []
    for name in ("flash_attention", "quantized_flash_attention", "dense_kv_attention",
                 "quantized_kv_attention"):
        def spy(*a, _name=name, _fn=getattr(TM, name), **kw):
            routes.append((_name, kw.get("row0", 0)))
            return _fn(*a, **kw)

        monkeypatch.setattr(TM, name, spy)
    cons = np.asarray([ord(c) for c in " The correct answer is"], np.int32)[None]  # ByteTokenizer ids

    def call(lm, proc, mod):
        steps = []
        eng, as_ids = (JE, jnp.asarray) if mod is JC else (TE, lambda x: torch.as_tensor(x).long())
        _, state, _, window = eng.run_prefill(lm, proc(QUESTION), 40)
        del routes[:]
        steps.append(lm.score_fn(1, 22, window, advance=0)(lm.params, as_ids(cons), state))
        for tok in (65, 66):
            plus = np.concatenate([[[tok]], cons], axis=1).astype(np.int32)
            lp, state = lm.score_fn(1, 23, window, advance=1)(lm.params, as_ids(plus), steps[-1][1])
            steps.append((lp, state))
        return len(steps)

    _, _, jsteps, tsteps = _run_both(_with_cache(pair, bits), monkeypatch, call)
    _assert_steps(jsteps, tsteps)
    assert [t.shape[1] for t in tsteps[1:]] == [22, 23, 23]
    decode = {"dense_kv_attention"} if bits != 4 else {"quantized_kv_attention"}
    n_layers = pair[1][0].cfg.num_hidden_layers
    assert {name for name, _ in routes} == decode
    assert sorted(row0 for _, row0 in routes) == [0] * 3 * n_layers + [16] * 3 * n_layers


def test_api_choose_matches_jax(pair):
    """Modelled on tests/test_e2e_text.py:test_choose."""
    (jlm, jproc), (tlm, tproc) = pair
    kw = dict(verbose=False)
    assert (TAPI.choose("Pick one: A or B?", choices="AB", preload=(tlm, tproc), **kw)
            == JAPI.choose("Pick one: A or B?", choices="AB", preload=(jlm, jproc), **kw))
    outs = TAPI.choose(["Pick!", "Choose!"], choices="ABC", preload=(tlm, tproc), **kw)
    assert outs == JAPI.choose(["Pick!", "Choose!"], choices="ABC", preload=(jlm, jproc), **kw)
    assert len(outs) == 2 and all(o in "ABC" for o in outs)


@pytest.mark.parametrize("use_beam", [False, True], ids=["greedy", "beam"])
def test_api_constrain_matches_jax(pair, use_beam):
    """Modelled on tests/test_e2e_text.py:test_constrain_greedy_and_beam."""
    (jlm, jproc), (tlm, tproc) = pair
    kw = dict(constraints=[(3, " The answer is"), "AB"], verbose=False, use_beam=use_beam)
    got = TAPI.constrain("Question?", preload=(tlm, tproc), **kw)
    assert got == JAPI.constrain("Question?", preload=(jlm, jproc), **kw)
    assert isinstance(got, str) and "answer is" in got


def test_api_constrain_default_constraints_match_jax(pair, capsys):
    """The JAX defaults: ``(0, "\\nThe")``, 100 free tokens before `` The
    correct answer is`` (22 ByteTokenizer tokens, the long-step route), then
    a letter."""
    (jlm, jproc), (tlm, tproc) = pair
    got = TAPI.constrain("Which is larger, 3 or 5?", preload=(tlm, tproc), verbose=True)
    printed = capsys.readouterr().out
    assert got == JAPI.constrain("Which is larger, 3 or 5?", preload=(jlm, jproc), verbose=False)
    assert "The correct answer is" in got and got[-1] in "ABCDE"
    assert "*** Prompt ***" in printed and "Constrain:" in printed


def test_entry_points_refuse_adapters(ckpt, tmp_path, monkeypatch):
    """The name is kept from when the port refused adapters; it now pins
    their use: with ``use_adapter=True`` and no preload, ``choose``,
    ``constrain`` and ``generate`` load ``adapters/<model name>`` beside
    the checkpoint, as the JAX entry points do, and give their output."""
    import functools
    import os

    from test_torch_lora import write_adapter

    monkeypatch.chdir(tmp_path)
    os.makedirs("models")
    os.symlink(ckpt, TAPI.PATH_ORIGINAL_PHI3_BLIND)
    write_adapter(TAPI._get_adapter_path(TAPI.PATH_ORIGINAL_PHI3_BLIND), torch_preset("tiny"), [1], seed=4,
                  model_path=TAPI.PATH_ORIGINAL_PHI3_BLIND)
    monkeypatch.setattr(TAPI, "load", functools.partial(TAPI.load, device="cpu"))
    kw = dict(blind_model=True, use_adapter=True, verbose=False)
    assert TAPI.choose("Hi", **kw) == JAPI.choose("Hi", **kw)
    assert TAPI.constrain("Hi", constraints=[(2, " A"), "AB"], **kw) == JAPI.constrain(
        "Hi", constraints=[(2, " A"), "AB"], **kw)
    gen = dict(max_tokens=6, stream=False, mute=True, **kw)
    assert TAPI.generate("Hi", **gen) == JAPI.generate("Hi", **gen)


def test_step_functions_check_their_shape(pair):
    _, (tlm, tproc) = pair
    _, state, _, window = TE.run_prefill(tlm, tproc("Hi"), 8)
    with pytest.raises(ValueError, match="made for"):
        tlm.score_fn(1, 2, window, advance=0)(tlm.params, torch.tensor([[5, 6, 7]]), state)
    with pytest.raises(ValueError, match="made for"):
        tlm.beam_fn(3, 2, window + 128, 3)(tlm.params, torch.zeros((3, 2), dtype=torch.long), state)
    lp, state2 = tlm.score_fn(1, 2, window, advance=1)(tlm.params, torch.tensor([[5, 6]]), state)
    assert lp.dtype == torch.float32 and lp.shape == (1, 2, tlm.cfg.vocab_size)
    assert state2.offset == state.offset + 1 and int(state2.pos) == state2.offset
    torch.testing.assert_close(lp.exp().sum(-1), torch.ones((1, 2)))
