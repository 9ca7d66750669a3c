"""The port's parity runbook (``phi_3_vision_mlx_tpu_torch/verify.py``)
against the JAX package's, and fp32 on the card's routes, on the CPU.

The JAX ``verify record`` writes goldens of BASELINE configs 1-5 from tiny
random checkpoints written by the JAX package (as tests/test_verify.py
does; the 4-bit copy's scales and biases made bf16-representable, as
``tests/test_torch_model.py:make_checkpoint`` makes them, since the port
keeps them in bf16).  The port's ``check`` passes on them, the port's
``record`` writes the same goldens field for field (but ``recorded_by``),
which the JAX ``check`` passes, and a corrupted golden fails.  The fp32
checks of ``LM`` and the engines run without a card, and plain-PyTorch
models of the card's fp32 K2 (64-row blocks, 64-key tiles, 3xTF32
products) and fp32 K3 (the bf16 split plan) are held to the plain versions
in fp32 at D = 96.
"""

import contextlib
import io
import json
import os
import re
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_attention import _k2_tile_model, _k3_split_model  # noqa: E402
from test_torch_model import VOCAB, make_checkpoint  # noqa: E402
from test_torch_speculative import one_thread  # noqa: E402,F401  (autouse: one torch thread)

from phi_3_vision_mlx_tpu import verify as JV  # noqa: E402
from phi_3_vision_mlx_tpu.core import weights as JW  # noqa: E402
from phi_3_vision_mlx_tpu_torch import verify as TV  # noqa: E402
from phi_3_vision_mlx_tpu_torch.core.config import KVQuantConfig, QuantConfig, preset  # noqa: E402
from phi_3_vision_mlx_tpu_torch.engine import batching as TB  # noqa: E402
from phi_3_vision_mlx_tpu_torch.engine import engine as TE  # noqa: E402
from phi_3_vision_mlx_tpu_torch.engine import paging as TP  # noqa: E402
from phi_3_vision_mlx_tpu_torch.ops.kernels import flash_attention as K2  # noqa: E402
from phi_3_vision_mlx_tpu_torch.ops.kernels import kv_attention as K3  # noqa: E402

CONFIGS = (1, 2, 3, 4, 5)
# fp32 on both sides, sums in another order: the top logits, perplexity and
# losses of the two packages agree far inside the runbook's own limits
# (RTOL_LOGITS 2e-3, RTOL_PPL 2e-2); goldens compare floats to this.
GOLDEN_FLOAT_RTOL = 1e-4
# fp32 attention at D = 96, each side summing in its own order: outputs of
# O(1) agree to a few e-7 (the card measured at most 1.2e-6).
F32_ATOL = 1e-5


@contextlib.contextmanager
def _cwd(path):
    old = os.getcwd()
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(old)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    root = tmp_path_factory.mktemp("verify")
    blind, vision = str(root / "blind"), str(root / "vision")
    blind_q = make_checkpoint(root, "blind")  # writes the unquantized pair at root / "blind"
    JW.create_random_checkpoint(vision, "tiny_vision", vocab_size=VOCAB)
    return {"root": root, "blind": blind, "blind_q": blind_q, "vision": vision}


def _args(ckpts, mode, golden, configs, port):
    args = [mode, "--golden", str(golden), "--configs", configs, "--dataset", "synthetic",
            "--take", "2", "--long-window", "256", "--lora-rank", "2", "--lora-layers", "2",
            "--blind-path", ckpts["blind"], "--quant-path", ckpts["blind_q"],
            "--vision-path", ckpts["vision"]]
    return args + ["--device", "cpu"] if port else args


def _record(ckpts, pkg, port: bool, name: str):
    """Goldens of configs 1-5 recorded by one package, in a working
    directory of their own."""
    golden = ckpts["root"] / f"goldens_{name}"
    work = ckpts["root"] / f"work_{name}"
    work.mkdir()
    with _cwd(work):
        assert pkg.main(_args(ckpts, "record", golden, ",".join(map(str, CONFIGS)), port)) == 0
    return golden


@pytest.fixture(scope="module")
def jax_goldens(ckpts):
    return _record(ckpts, JV, False, "jax")


@pytest.fixture(scope="module")
def port_goldens(ckpts):
    return _record(ckpts, TV, True, "port")


def _golden(path, n):
    with open(os.path.join(path, f"{TV.CFG_NAMES[n]}.json")) as f:
        return json.load(f)


def _copy_goldens(src, dst):
    os.makedirs(dst)
    for n in CONFIGS:
        shutil.copy(os.path.join(src, f"{TV.CFG_NAMES[n]}.json"), dst)
    return dst


@pytest.fixture(scope="module")
def port_check(ckpts, jax_goldens):
    """The port's ``check`` of configs 1-5 on the CPU, once, over copies of
    the JAX goldens: (each config's printed verdict, the output, the goldens
    checked)."""
    work = ckpts["root"] / "check_port"
    golden = _copy_goldens(jax_goldens, work / "goldens")
    out = io.StringIO()
    with _cwd(work), contextlib.redirect_stdout(out):
        TV.main(_args(ckpts, "check", golden, ",".join(map(str, CONFIGS)), port=True))
    text = out.getvalue()
    return dict(re.findall(r"^(\S+): (PASS|FAIL)$", text, re.M)), text, golden


@pytest.mark.parametrize("n", CONFIGS)
def test_port_check_passes_on_jax_goldens(port_check, n):
    """The port's ``check`` of each config on the CPU passes on the goldens
    the JAX ``record`` wrote from the same checkpoints (one ``check`` run of
    all five configs; each case reads its config's verdict)."""
    verdicts, text, golden = port_check
    assert _golden(golden, n)["recorded_by"] == "phi_3_vision_mlx_tpu"
    assert verdicts.get(TV.CFG_NAMES[n]) == "PASS", text


def test_jax_check_passes_on_port_goldens(ckpts, port_goldens, tmp_path):
    """The JAX ``check`` passes on the goldens the port recorded."""
    golden = _copy_goldens(port_goldens, tmp_path / "goldens")
    with _cwd(tmp_path):
        assert JV.main(_args(ckpts, "check", golden, ",".join(map(str, CONFIGS)), port=False)) == 0


def _same(a, b, where=""):
    """Equal structure and values; floats to GOLDEN_FLOAT_RTOL."""
    assert type(a) is type(b), where
    if isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif isinstance(a, float):
        assert np.isclose(a, b, rtol=GOLDEN_FLOAT_RTOL, atol=0), (where, a, b)
    else:
        assert a == b, (where, a, b)


@pytest.mark.parametrize("n", CONFIGS)
def test_port_goldens_equal_jax_field_for_field(jax_goldens, port_goldens, n):
    """Schema-1 goldens of both packages: every field equal (tokens, answers,
    accuracies, the long window's prompt size exactly; floats to
    GOLDEN_FLOAT_RTOL) but ``recorded_by``; each package's ``_diff`` finds
    nothing either way."""
    jg, tg = _golden(jax_goldens, n), _golden(port_goldens, n)
    assert (jg.pop("recorded_by"), tg.pop("recorded_by")) == ("phi_3_vision_mlx_tpu",
                                                             "phi_3_vision_mlx_tpu_torch")
    _same(jg, tg, TV.CFG_NAMES[n])
    assert jg["schema"] == 1 and jg["cases"]
    for diff in (JV._diff, TV._diff):
        assert diff(jg["config"], jg, tg) == [] and diff(jg["config"], tg, jg) == []


def test_corrupted_golden_fails(ckpts, port_goldens, tmp_path):
    """A flipped token id in the cfg1 golden fails the port's ``check``."""
    golden = _copy_goldens(port_goldens, tmp_path / "goldens")
    path = os.path.join(golden, f"{TV.CFG_NAMES[1]}.json")
    g = _golden(golden, 1)
    g["cases"][0]["tokens"][0][0] ^= 1
    with open(path, "w") as f:
        json.dump(g, f)
    with _cwd(tmp_path):
        assert TV.main(_args(ckpts, "check", golden, "1", port=True)) == 1


def test_cfg1_decodes_in_fp32_from_a_bf16_checkpoint(tmp_path, monkeypatch):
    """Config 1 is the fp32 gate: the port loads a bf16 checkpoint's text
    model in fp32 (the config key ``jax_dtype``).  The JAX runbook asks for
    ``dtype="float32"``, which its config reader ignores: it decodes such a
    checkpoint in bf16 (a reference fault, ROADMAP queue 3; on the tiny fp32
    checkpoints above both run fp32)."""
    from phi_3_vision_mlx_tpu.api import _load as jax_load
    from phi_3_vision_mlx_tpu_torch.core import weights as TW

    path = str(tmp_path / "bf16")
    TW.create_random_checkpoint(path, "tiny", vocab_size=VOCAB, dtype="bfloat16")
    seen = {}

    def greedy(lm, proc, prompt, max_tokens, images=None):
        seen["dtype"] = lm.cfg.dtype
        seen["embed"] = lm.params["model"]["embed_tokens"]["weight"].dtype
        return [[1]], {"ids": [1], "vals": [0.0]}

    monkeypatch.setattr(TV, "_greedy_tokens", greedy)
    TV.run_cfg1(TV.argparse.Namespace(blind_path=path, device="cpu"))
    assert seen == {"dtype": "float32", "embed": torch.float32}
    assert jax_load(path, dtype="float32")[0].cfg.dtype == "bfloat16"


def test_diff_and_constants_match_jax():
    """The port's copies of the runbook's constants equal the JAX ones, and
    ``_diff`` fails on the same drifts (a token, a top-logit value past
    RTOL_LOGITS, a perplexity past RTOL_PPL, an accuracy)."""
    for name in ("TOPK", "RTOL_LOGITS", "RTOL_PPL", "CFG_NAMES", "_PROMPT_CFG1", "_PROMPTS_CFG2",
                 "_PPL_TEXT"):
        assert getattr(TV, name) == getattr(JV, name), name
    base = {"cases": [{"tokens": [[1, 2]], "top_logits": {"ids": [3], "vals": [10.0]}}],
            "scores": {"quantized_ppl": 5.0, "choose_acc": 0.5, "first_loss": None}}
    drifts = [
        {"cases": [{"tokens": [[1, 3]], "top_logits": {"ids": [3], "vals": [10.0]}}], "scores": {}},
        {"cases": [{"tokens": [[1, 2]], "top_logits": {"ids": [3], "vals": [10.03]}}], "scores": {}},
        {"cases": [{"tokens": [[1, 2]], "top_logits": {"ids": [3], "vals": [10.01]}}], "scores": {}},
        {"cases": base["cases"], "scores": {"quantized_ppl": 5.2, "choose_acc": 0.5}},
        {"cases": base["cases"], "scores": {"quantized_ppl": 5.05, "choose_acc": 0.6}},
    ]
    for fresh in drifts:
        assert TV._diff("c", base, fresh) == JV._diff("c", base, fresh)
    assert TV._diff("c", base, drifts[2]) == [] and len(TV._diff("c", base, drifts[0])) == 1


def _flags(main, capsys):
    with pytest.raises(SystemExit):
        main(["--help"])
    return {w.split("=")[0].rstrip(",") for w in capsys.readouterr().out.split() if w.startswith("--")}


def test_cli_matches_jax(capsys):
    """Same modes and flags as the JAX CLI, plus ``--device``."""
    assert _flags(TV.main, capsys) == _flags(JV.main, capsys) | {"--device"}


# -- fp32 on the card's routes -------------------------------------------------


FP32_REFUSED = {
    "4-bit weights": dict(quantized=QuantConfig(group_size=64, bits=4)),
    "8-bit weights": dict(quantized=QuantConfig(group_size=64, bits=8)),
    "the int4 KV cache": dict(use_quantized_cache=True),
    "the int8 KV cache": dict(use_quantized_cache=True, kv_quant=KVQuantConfig(group_size=32, bits=8)),
}


def _mock_cuda(monkeypatch):
    """A card as far as ``LM`` asks: available, 80 GiB of memory."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: type("Props", (), {"total_memory": 80 << 30})())


@pytest.mark.parametrize("combo", list(FP32_REFUSED))
def test_fp32_on_cuda_refuses_other_combinations(combo, monkeypatch):
    """Every fp32 combination that fp32 on CUDA once refused (quantized
    weights, the quantized caches) now passes ``check_cuda_dtype`` and
    builds an ``LM`` on the card (mocked: the check runs before any tensor
    moves), as bf16 does: each kernel has an fp32 entry."""
    cfg = preset("tiny").replace(dtype="float32", **FP32_REFUSED[combo])
    assert TE.check_cuda_dtype(cfg) is None
    _mock_cuda(monkeypatch)
    lm = TE.LM(cfg, {}, device="cuda")
    assert lm.device.type == "cuda" and lm.cfg.dtype == "float32" and lm.graphs
    assert TE.check_cuda_dtype(cfg.replace(dtype="bfloat16")) is None
    with pytest.raises(ValueError, match="bf16 or fp32"):
        TE.check_cuda_dtype(cfg.replace(dtype="float16"))


def test_fp32_on_cuda_accepts_the_single_stream_dense_path():
    """fp32 with unquantized weights and the dense cache passes the check
    (and bf16 as before); another dtype does not."""
    assert TE.check_cuda_dtype(preset("tiny").replace(dtype="float32")) is None
    assert TE.check_cuda_dtype(preset("tiny").replace(dtype="bfloat16")) is None
    with pytest.raises(ValueError, match="bf16 or fp32"):
        TE.check_cuda_dtype(preset("tiny").replace(dtype="float16"))


class _Reached(Exception):
    """The engine got as far as allocating its state."""


@pytest.mark.parametrize("engine", [TB.BatchEngine, TP.PagedBatchEngine])
def test_fp32_on_cuda_refuses_the_batching_engines(engine, monkeypatch):
    """The slot and paged engines take an fp32 model on CUDA: over a stub
    card model with 4-bit, 8-bit or packed weights and the dense, int4 or
    int8 cache, the constructor goes on to allocate its state (stubbed: the
    CPU has no card); and a tiny fp32 4-bit model over the int4 cache builds
    the engine on the CPU."""
    def reached(self):
        raise _Reached(self.lm.cfg)

    monkeypatch.setattr(engine, "_init_state", reached)
    tiny = preset("tiny").replace(dtype="float32")
    combos = [dict(quantized=QuantConfig(group_size=64, bits=bits)) for bits in (4, 8)]
    combos += [dict(quantized=QuantConfig(group_size=64, bits=4), use_quantized_cache=True,
                    kv_quant=KVQuantConfig(group_size=32, bits=bits)) for bits in (4, 8)]
    for kw in combos:
        cuda_lm = type("StubLM", (), {"device": torch.device("cuda"), "cfg": tiny.replace(**kw)})()
        with pytest.raises(_Reached):
            engine(cuda_lm, None, slots=2, window=256)
    monkeypatch.undo()
    from phi_3_vision_mlx_tpu_torch.core.weights import synth_quantized_params

    cfg = tiny.replace(quantized=QuantConfig(group_size=64, bits=4), use_quantized_cache=True)
    lm = TE.LM(cfg, synth_quantized_params(cfg, device="cpu"), device="cpu")
    eng = engine(lm, None, slots=2, window=256)
    assert eng.state.k.dtype == torch.uint8 and eng.state.valid.shape == (2, 256)


def test_fp32_wrappers_take_fp32_and_refuse_mixed_types():
    """K2's and K3's input checks take fp32 q/k/v as they take bf16 ones, and
    refuse a mix of the two."""
    q = torch.empty((1, 2, 1, 96), dtype=torch.float32, device="meta")
    k = torch.empty((1, 2, 8, 96), dtype=torch.float32, device="meta")
    valid = torch.empty((1, 8), dtype=torch.bool, device="meta")
    K2.check_attention_inputs(q, k, k, valid, "flash_attention")
    K2.check_attention_inputs(q.bfloat16(), k.bfloat16(), k.bfloat16(), valid, "flash_attention")
    with pytest.raises(TypeError, match="bf16 or fp32"):
        K2.check_attention_inputs(q, k.bfloat16(), k.bfloat16(), valid, "flash_attention")
    with pytest.raises(TypeError, match="bf16 or fp32"):
        K2.check_attention_inputs(q.half(), k.half(), k.half(), valid, "flash_attention")
    assert K2.flash_attention.fp32.launches == 0 and K3.dense_kv_attention.fp32.launches == 0


D96 = 96
SCALE96 = D96**-0.5
# (lq, q_pos0, lk, left pads per batch row): a left-padded prompt bucket, a
# batch of two pads, an extend chunk, tiles off 64, and a row with no valid
# key at all (the uniform average of every value).
K2_F32_EDGES = {
    "prompt-bucket": (64, 0, 128, (14,)),
    "batch-pads": (70, 0, 100, (0, 40)),
    "extend": (40, 200, 240, (12,)),
    "ragged": (45, 3, 77, (5,)),
    "no-valid-key": (33, 0, 70, (70,)),
}


def _k2_fp32_inputs(lq, lk, pads, h, kvh, seed):
    b = len(pads)
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((b, h, lq, D96)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((b, kvh, lk, D96)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((b, kvh, lk, D96)).astype(np.float32))
    valid = torch.ones((b, lk), dtype=torch.bool)
    for bi, pad in enumerate(pads):
        valid[bi, :pad] = False
    return q, k, v, valid


@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("edge", list(K2_F32_EDGES))
def test_k2_fp32_tile_walk_matches_plain(edge, g):
    """The card's fp32 K2 walk (64-row blocks, 64-key tiles, both products
    in 3xTF32, an online softmax, causal skipping but for rows that have
    seen no key) equals flash_attention_plain in fp32 at D = 96."""
    lq, q_pos0, lk, pads = K2_F32_EDGES[edge]
    q, k, v, valid = _k2_fp32_inputs(lq, lk, pads, 2 * g, 2, sorted(K2_F32_EDGES).index(edge) + 10 * g)
    out = _k2_tile_model(q, k, v, valid, q_pos0, SCALE96, round_p=False, tile=64, tf32x3=True)
    ref = K2.flash_attention(q, k, v, valid, q_pos0, SCALE96)  # the plain version on the CPU
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=0, atol=F32_ATOL)
    if edge == "no-valid-key":
        mean_v = v[0].mean(dim=1).repeat_interleave(g, dim=0)
        for i in range(lq):
            np.testing.assert_allclose(out[0, :, i].numpy(), mean_v.numpy(), rtol=0, atol=F32_ATOL)


def test_k2_fp32_tile_walk_full_width():
    """The 3xTF32 walk at chip_smoke.py's timed shape, lq 1024 over 1152
    keys with 24 left-pad rows, on one pair of query heads over one kv head:
    within F32_ATOL of the plain fp32 version, the card's limit, so the
    error budget is known before a chip run."""
    q, k, v, valid = _k2_fp32_inputs(1024, 1152, (24,), 2, 1, 1024)
    out = _k2_tile_model(q, k, v, valid, 0, SCALE96, round_p=False, tile=64, tf32x3=True)
    ref = K2.flash_attention(q, k, v, valid, 0, SCALE96)
    err = (out - ref).abs().max().item()
    assert 0 < err <= F32_ATOL, err


@pytest.mark.parametrize("lq,row0", [(1, 0), (8, 0), (16, 0), (16, 16)])
@pytest.mark.parametrize("offset", [100, 4224 - 40])
def test_k3_fp32_plan_matches_plain(lq, row0, offset):
    """K3 in fp32 keeps the bf16 plan (64-key splits of the window, the
    fixed-order merge): its model equals dense_kv_attention_plain in fp32 at
    D = 96, at a short and a late offset of a 4224-key window, one to 16
    rows, and a later row group."""
    nl, b, kvh, lmax, layer = 1, 1, 2, 4224, 0
    rng = np.random.default_rng(lq + row0 + offset)
    ks = torch.from_numpy(rng.standard_normal((nl, b, kvh, lmax, D96)).astype(np.float32))
    vs = torch.from_numpy(rng.standard_normal((nl, b, kvh, lmax, D96)).astype(np.float32))
    q = torch.from_numpy(rng.standard_normal((b, 2 * kvh, lq, D96)).astype(np.float32))
    valid = torch.from_numpy(rng.random((b, lmax)) > 0.05)
    valid[:, :10] = False
    out, _ = _k3_split_model(q, ks, vs, valid, offset, layer, SCALE96, row0)
    ref = K3.dense_kv_attention_plain(q, ks, vs, valid, offset, layer, SCALE96, row0)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=0, atol=F32_ATOL)
    assert K3.dense_kv_split_plan(lmax) == (66, 64)
