"""The port's training and adapter flows (``train/``, ``api`` with
``use_adapter``) against the JAX package on the CPU in fp32, on a 2-layer
tiny checkpoint with 4-bit weights that the JAX package wrote.

* the data pipeline value for value (rows, prompts, mask augmentation,
  padded batches, the learning-rate schedule), and the dataset sources
  offline;
* ``train_lora`` against the JAX one from the same initial A (handed over
  through the trainer's ``inject_lora``), with and without ``mask_ratios``:
  each step's loss, the adapters, and the files' keys;
* resume from the port's own train state against an uninterrupted run;
* adapters written by either package loaded by the other, then
  ``generate`` / ``choose`` / ``constrain`` with ``use_adapter=True`` token
  for token against JAX, with the dense and the int4 cache (JAX's int4
  entries replayed, ``tests/test_torch_model.py:ReplayJaxCache``);
* ``test_lora``'s scores and CSV against JAX's;
* ``make_clm_loss`` and three ``pretrain`` steps against JAX.
"""

import csv
import functools
import json
import os
import random
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_constrain import QUESTION, _run_both  # noqa: E402
from test_torch_lora import TARGETS, port_cfg, port_proc, write_adapter  # noqa: E402
from test_torch_model import PROMPT, ReplayJaxCache, _jax_decode, make_checkpoint  # noqa: E402
from test_torch_speculative import one_thread  # noqa: E402,F401  (autouse: one torch thread)

from phi_3_vision_mlx_tpu import api as JAPI  # noqa: E402
from phi_3_vision_mlx_tpu.core import weights as JW  # noqa: E402
from phi_3_vision_mlx_tpu.core.config import preset as jax_preset  # noqa: E402
from phi_3_vision_mlx_tpu.models import phi3 as JM  # noqa: E402
from phi_3_vision_mlx_tpu.train import data as JD  # noqa: E402
from phi_3_vision_mlx_tpu.train import lora as JLORA  # noqa: E402
from phi_3_vision_mlx_tpu.train import pretrain as JP  # noqa: E402
from phi_3_vision_mlx_tpu.train import trainer as JT  # noqa: E402
from phi_3_vision_mlx_tpu_torch import api as TAPI  # noqa: E402
from phi_3_vision_mlx_tpu_torch.core import weights as TW  # noqa: E402
from phi_3_vision_mlx_tpu_torch.core.convert import from_numpy_params  # noqa: E402
from phi_3_vision_mlx_tpu_torch.models import phi3 as TM  # noqa: E402
from phi_3_vision_mlx_tpu_torch.train import data as TD  # noqa: E402
from phi_3_vision_mlx_tpu_torch.train import pretrain as TP  # noqa: E402
from phi_3_vision_mlx_tpu_torch.train import trainer as TT  # noqa: E402

LOSS_RTOL = 1e-4
# The saved adapters (after 3 AdamW steps at rates 1e-6, 1e-4, 5.05e-5)
# of the two packages.  Adam's normalization turns a gradient element near
# zero into a whole step of either sign, so where the two packages' f32
# gradients parted in sign an element would differ by up to the sum of the
# rates, 1.5e-4.  On these inputs none does: the largest difference
# measured was 8.0e-8 (median 1.9e-10), f32 rounding of values up to 1e-1.
ADAPTER_ATOL = 1e-6
TRAIN_KW = dict(lora_targets=TARGETS, lora_layers=2, lora_rank=4, take=4, dataset_path="synthetic")
MODEL = "phi3_mini_128k_Q"  # api.PATH_QUANTIZED_PHI3_BLIND's name


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return make_checkpoint(tmp_path_factory.mktemp("ckpt"), "tiny")


# -- the data pipeline ------------------------------------------------------------


def test_data_pipeline_matches_jax(ckpt, tmp_path):
    """Rows from every local source, prompts, the mask augmentation and the
    padded batch (with and without ``mask_ratios``) and the schedule, value
    for value."""
    rows = TD.synthetic_qa(12)
    assert rows == JD.synthetic_qa(12)
    with open(tmp_path / "rows.json", "w") as f:
        json.dump(rows, f)
    with open(tmp_path / "rows.jsonl", "w") as f:
        f.write("\n".join(json.dumps(r) for r in rows) + "\n")
    for source, take in (("synthetic", 4), ("synthetic", (2, 5)), (str(tmp_path / "rows.json"), 3),
                         (str(tmp_path / "rows.jsonl"), (1, 4)), (rows, None)):
        assert TD.load_qa_dataset(source, take) == JD.load_qa_dataset(source, take)
    with pytest.raises(ValueError, match="only contains"):
        TD.load_qa_dataset(rows[:2], 3)
    prompts = TT._prompt_rows(rows)
    assert prompts == JT._prompt_rows(rows)
    _, jproc = JAPI._load(ckpt)
    tproc = port_proc(ckpt)
    for mask_ratios, n in ((None, 1), ([0.0, 0.3], 2), ([0.5], 3)):
        want = JT._prepare_batch(jproc, prompts[:n], mask_ratios, random.Random(n))
        got = TT._prepare_batch(tproc, prompts[:n], mask_ratios, random.Random(n))
        assert sorted(got) == sorted(want)
        for key in want:
            np.testing.assert_array_equal(got[key], np.asarray(want[key]), err_msg=key)
    for steps, warmup in ((4, 0.5), (10, 0.0), (7, 0.3)):
        np.testing.assert_array_equal(TT._get_lr_schedule(1e-4, steps, warmup),
                                      JT._get_lr_schedule(1e-4, steps, warmup))


def test_hub_dataset_never_downloads_offline(monkeypatch):
    """A hub id with ``HF_HUB_OFFLINE`` set: no ``datasets`` import; the
    synthetic rows under ``PHI3V_TPU_ALLOW_RANDOM=1``, as JAX gives them,
    and ``RuntimeError`` without it."""
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setitem(__import__("sys").modules, "datasets", None)
    monkeypatch.setenv("PHI3V_TPU_ALLOW_RANDOM", "1")
    assert TD.load_qa_dataset("JosefAlbers/akemiH_MedQA_Reason", 3) == JD.synthetic_qa(10)[:3]
    monkeypatch.delenv("PHI3V_TPU_ALLOW_RANDOM")
    with pytest.raises(RuntimeError, match="HF_HUB_OFFLINE"):
        TD.load_qa_dataset("JosefAlbers/akemiH_MedQA_Reason", 3)


# -- train_lora against JAX --------------------------------------------------------


def _jax_a(ckpt, rank):
    """The JAX trainer's initial A of each target (seed 0)."""
    jlm, _ = JAPI._load(ckpt)
    params, _ = JLORA.inject_lora(jlm.params, jlm.cfg, TARGETS, 2, rank, jax.random.PRNGKey(0),
                                  alpha=rank, scale=1.0)
    out = {}
    for t in TARGETS:
        node = params["model"]["layers"]
        for part in t.split("."):
            node = node[part]
        out[t] = np.asarray(node["lora_a"])
    return out


def _handing_over(jax_a):
    """The port trainer's ``inject_lora`` with the JAX package's A."""
    real = TT.inject_lora

    def inject(params, cfg, targets, layers, rank, generator, **kw):
        params, mask = real(params, cfg, targets, layers, rank, generator, **kw)
        for t in targets:
            node = params["model"]["layers"]
            for part in t.split("."):
                node = node[part]
            node["lora_a"] = torch.from_numpy(np.array(jax_a[t])).to(node["lora_a"].device)
        return params, mask

    return inject


def _train_log(path):
    with open(f"{path}/adapter_train_log.json") as f:
        return json.load(f)


@pytest.fixture(scope="module", params=[None, [0.2]], ids=["plain", "mask_ratios"])
def runs(request, ckpt, tmp_path_factory):
    """One JAX and one port ``train_lora`` over the 4-bit checkpoint, from
    the same initial A, 4 steps (batches of 1 row of 192 tokens: K1's seam;
    with ``mask_ratios`` 2 rows, 384: the dequantize route's)."""
    root = tmp_path_factory.mktemp("train")
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(root)
        JT.train_lora(model_path=ckpt, adapter_path=str(root / "jax"), mask_ratios=request.param, **TRAIN_KW)
        mp.setattr(TT, "inject_lora", _handing_over(_jax_a(ckpt, TRAIN_KW["lora_rank"])))
        TT.train_lora(model_path=ckpt, adapter_path=str(root / "torch"), mask_ratios=request.param,
                      device="cpu", **TRAIN_KW)
    return str(root / "jax"), str(root / "torch")


def test_train_lora_losses_match_jax(runs):
    jlog, tlog = map(_train_log, runs)
    assert len(tlog["step_loss"]) == len(jlog["step_loss"]) == 4
    np.testing.assert_allclose(tlog["step_loss"], jlog["step_loss"], rtol=LOSS_RTOL, atol=0)
    assert tlog["avg_i"] == jlog["avg_i"] == [3]
    np.testing.assert_allclose(tlog["avg_loss"], jlog["avg_loss"], rtol=LOSS_RTOL, atol=0)


def test_train_lora_adapters_match_jax(runs):
    """The best-loss adapters (after step 3) within ADAPTER_ATOL, their keys
    and the two JSON files' keys equal."""
    jdir, tdir = runs
    want = TW.load_safetensors(f"{jdir}/adapters.safetensors")
    got = TW.load_safetensors(f"{tdir}/adapters.safetensors")
    assert sorted(got) == sorted(want) and len(got) == 2 * 2 * len(TARGETS)
    diffs = []
    for key in want:
        assert got[key].dtype == torch.float32 and got[key].shape == want[key].shape
        diffs.append((got[key] - want[key]).abs().flatten())
    diffs = torch.cat(diffs)
    assert float(diffs.max()) <= ADAPTER_ATOL and float(diffs.median()) <= 1e-7, (diffs.max(), diffs.median())
    assert any(float(got[k].abs().max()) > 0 for k in got if k.endswith("lora_b"))
    for name in ("adapter_config.json", "adapter_train_log.json"):
        with open(f"{jdir}/{name}") as f:
            jj = json.load(f)
        with open(f"{tdir}/{name}") as f:
            tt = json.load(f)
        assert sorted(tt) == sorted(jj)
    with open(f"{tdir}/adapter_config.json") as f:
        tcfg = json.load(f)
    with open(f"{jdir}/adapter_config.json") as f:
        jcfg = json.load(f)
    assert tcfg["lora_parameters"] == jcfg["lora_parameters"] and tcfg["lora_targets"] == jcfg["lora_targets"]


def test_train_lora_resume_matches_uninterrupted(ckpt, tmp_path, monkeypatch):
    """``checkpoint_every=1`` keeps the 3 newest train states; resuming
    from step 2 gives the uninterrupted run's losses and adapter exactly."""
    monkeypatch.chdir(tmp_path)
    kw = dict(model_path=ckpt, lora_layers=1, lora_rank=2, take=4, dataset_path="synthetic", seed=3,
              device="cpu")
    TT.train_lora(adapter_path=str(tmp_path / "full"), **kw)
    resumed = str(tmp_path / "resumed")
    TT.train_lora(adapter_path=resumed, checkpoint_every=1, **kw)
    assert sorted(os.listdir(f"{resumed}/train_state")) == ["2", "3", "4"]
    for step in ("3", "4"):
        shutil.rmtree(f"{resumed}/train_state/{step}")
    os.remove(f"{resumed}/adapters.safetensors")
    TT.train_lora(adapter_path=resumed, resume=True, **kw)
    full, res = _train_log(tmp_path / "full"), _train_log(resumed)
    assert res["step_i"] == [3, 4] and res["step_loss"] == full["step_loss"][2:]
    a = TW.load_safetensors(f"{tmp_path}/full/adapters.safetensors")
    b = TW.load_safetensors(f"{resumed}/adapters.safetensors")
    assert sorted(a) == sorted(b) and all(torch.equal(a[k], b[k]) for k in a)


# -- adapters both ways, and served through the entry points --------------------------


def test_adapters_cross_load_both_ways(ckpt, runs):
    """The JAX-trained adapter through the port's ``load_adapter`` and the
    port-trained one through JAX's, each equal to its own package's."""
    jcfg, jparams = JW.load_params(ckpt)
    tcfg, tparams = TW.load_params(ckpt)
    tparams = TW.prepare_params(tparams, tcfg)
    for path in runs:
        jp = JW.load_adapter(jparams, jcfg, path)
        tp = TW.load_adapter(tparams, tcfg, path)
        for t in TARGETS:
            jn, tn = jp["model"]["layers"], tp["model"]["layers"]
            for part in t.split("."):
                jn, tn = jn[part], tn[part]
            for key in ("lora_a", "lora_b", "lora_scale"):
                np.testing.assert_array_equal(tn[key].numpy(), np.asarray(jn[key]))


@pytest.fixture
def served(ckpt, tmp_path, monkeypatch):
    """A working directory holding ``models/<MODEL>`` (the checkpoint) and
    ``adapters/<MODEL>`` (a random adapter the port wrote), so that
    ``use_adapter=True`` finds both; the port's ``load`` runs on the CPU."""
    monkeypatch.chdir(tmp_path)
    os.makedirs("models")
    os.symlink(ckpt, f"models/{MODEL}")
    cfg, _ = TW.load_params(ckpt)
    write_adapter(f"adapters/{MODEL}", cfg, [0, 1], seed=11, model_path=f"models/{MODEL}")
    monkeypatch.setattr(TAPI, "load", functools.partial(TAPI.load, device="cpu"))
    return dict(blind_model=True, quantize_model=True, use_adapter=True)


def test_adapter_entry_points_match_jax_dense(served):
    """``generate``, ``choose`` and ``constrain`` (greedy and beam) with
    ``use_adapter=True`` give the JAX package's tokens; the adapter moves
    the output."""
    kw = dict(verbose=False)
    gen = dict(max_tokens=12, stream=False, mute=True, **kw)
    got = TAPI.generate("Tell me about lighthouses.", **served, **gen)
    assert got == JAPI.generate("Tell me about lighthouses.", **served, **gen)
    assert got != TAPI.generate("Tell me about lighthouses.", **{**served, "use_adapter": False}, **gen)
    assert (TAPI.choose(["Pick!", "Choose!"], choices="ABC", **served, **kw)
            == JAPI.choose(["Pick!", "Choose!"], choices="ABC", **served, **kw))
    for use_beam in (False, True):
        c = dict(constraints=[(3, " The answer is"), "AB"], use_beam=use_beam, **kw)
        assert TAPI.constrain("Question?", **served, **c) == JAPI.constrain("Question?", **served, **c)


def test_adapter_entry_points_match_jax_int4(served, monkeypatch):
    """The same with the int4 cache (``quantize_cache=True``): ``generate``
    and ``constrain`` write the JAX package's quantized entries
    (``ReplayJaxCache``, ``ReplayJaxSteps``)."""
    flags = dict(served, quantize_cache=True)
    jlm, jproc = JAPI.load(**flags)
    tlm, tproc = TAPI.load(**flags)
    assert tlm.cfg.use_quantized_cache and "lora_a" in tlm.params["model"]["layers"]["self_attn"]["qkv_proj"]
    _, jstate = _jax_decode(jlm, jproc(PROMPT), 12)
    replay = ReplayJaxCache(jstate, tlm.cfg.kv_quant.bits)
    monkeypatch.setattr(TM, "update_layer_chunk", replay)
    gen = dict(max_tokens=12, stream=False, mute=True, verbose=False, apply_chat_template=False)
    assert (TAPI.generate(PROMPT, preload=(tlm, tproc), **gen)
            == JAPI.generate(PROMPT, preload=(jlm, jproc), **gen))
    replay.check()
    monkeypatch.undo()
    monkeypatch.setattr(TAPI, "load", functools.partial(TAPI.load, device="cpu"))

    def call(lm, proc, mod):
        api = JAPI if lm is jlm else TAPI
        return api.constrain(QUESTION, constraints=[(3, " A"), "AB"], preload=(lm, proc), verbose=False,
                             apply_chat_template=False)

    want, got, jsteps, tsteps = _run_both(((jlm, jproc), (tlm, tproc)), monkeypatch, call)
    assert got == want and len(tsteps) == len(jsteps) > 0


def test_test_lora_matches_jax(served, tmp_path):
    """``test_lora`` on two synthetic rows with the adapter: the three
    scores and the CSV (every attempt column) equal JAX's."""
    kw = dict(model_path=f"models/{MODEL}", dataset_path="synthetic", take=2)
    want = JT.test_lora(test_result_path=str(tmp_path / "jax.csv"), **kw)
    got = TT.test_lora(test_result_path=str(tmp_path / "torch.csv"), device="cpu", **kw)
    assert got == want
    rows = [list(csv.reader(open(tmp_path / f"{n}.csv", newline=""))) for n in ("jax", "torch")]
    assert rows[1] == rows[0] and len(rows[0]) == 3
    assert {"summary_attempt", "choice_attempt", "constrained_attempt", "beamed_attempt"} <= set(rows[0][0])


# -- pretraining -------------------------------------------------------------------


def test_pretrain_matches_jax():
    """The induction corpus value for value, ``make_clm_loss`` and three
    AdamW steps of ``pretrain`` (warmup-cosine rate: 0, then 5e-5, 1e-4)
    from the same weights: each step's loss within LOSS_RTOL and the
    weights within 2e-4 (three steps' rates: Adam's sign on near-zero
    gradients)."""
    batches = TP.induction_batches(1, 3, 2, 64)
    want_batches = JP.induction_batches(1, 3, 2, 64)
    for (i, v), (ji, jv) in zip(batches, want_batches):
        np.testing.assert_array_equal(i, ji)
        np.testing.assert_array_equal(v, jv)
    jcfg = jax_preset("tiny", vocab_size=TP.INDUCTION_VOCAB)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = port_cfg(jcfg)
    tparams = from_numpy_params(jax.tree_util.tree_map(np.asarray, jparams), tcfg)
    ids, valid = batches[0]
    want = float(JP.make_clm_loss(jcfg)(jparams, jnp.asarray(ids), jnp.asarray(valid)))
    got = float(TP.make_clm_loss(tcfg)(tparams, torch.from_numpy(ids), torch.from_numpy(valid)))
    assert abs(got - want) <= LOSS_RTOL * abs(want)
    jout, jlosses = JP.pretrain(jcfg, jparams, want_batches, lr=1e-3, warmup=2, steps=3)
    tout, tlosses = TP.pretrain(tcfg, tparams, batches, lr=1e-3, warmup=2, steps=3)
    np.testing.assert_allclose(tlosses, jlosses, rtol=LOSS_RTOL, atol=0)
    flat_j = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, jout))
    flat_t = jax.tree_util.tree_leaves(tout)
    assert len(flat_j) == len(flat_t)
    for j, t in zip(flat_j, flat_t):
        np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=2e-4)
    assert not any(t.requires_grad for t in flat_t)
    assert [TP.warmup_cosine(s, 1e-3, 2, 3) for s in range(3)] == pytest.approx([0.0, 5e-4, 1e-3])
