"""The experiment kernels E1-E3 and the port's experiment entry points,
against the JAX package's experiment scripts on the CPU.

The scripts under ``experiments/`` are loaded from their file paths (they
are no package).  ``w4a8_matmul`` takes ``interpret=True``; ``probe_attention``
and ``qkv_attn`` run in interpret mode through a test-local stand-in for
their module's ``pl`` (as in ``tests/test_torch_w8.py``).  Their caches are
in the TPU layout (transposed, head dim permuted); the port reads the same
bytes through ``core/convert.py:from_jax_kv_cache``.

Tolerances: E1, exact integer group sums and the same f32 order of the
scaled sums, 1e-5 of the output's scale; E2/E3, 2e-2 as for K4's plain
version against the JAX K4 (``tests/test_torch_kv_quant.py``): the TPU
kernels round p to bf16 before p . v and scale the scores after the dot.
"""

import importlib.util
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from test_torch_w8 import _InterpretPallas  # noqa: E402

from phi_3_vision_mlx_tpu_torch.core import weights as TW  # noqa: E402
from phi_3_vision_mlx_tpu_torch.core.convert import d_perm, from_jax_kv_cache  # noqa: E402
from phi_3_vision_mlx_tpu_torch.experiments import qdecode_sweep, qkv_probe, w4a8_bench  # noqa: E402
from phi_3_vision_mlx_tpu_torch.ops.kernels import kv_attention as TKV  # noqa: E402
from phi_3_vision_mlx_tpu_torch.ops.kernels.quant_matmul import quant_matmul_plain  # noqa: E402
from phi_3_vision_mlx_tpu_torch.ops.kernels import w4a8 as TE1  # noqa: E402
from test_torch_model import one_thread  # noqa: E402,F401  (autouse: one torch thread)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
E1_TOL = 1e-5
KERNEL_TOL = dict(rtol=2e-2, atol=2e-2)


def _script(name):
    """A JAX experiment script, imported from its file path."""
    spec = importlib.util.spec_from_file_location(f"jax_{name}", os.path.join(ROOT, "experiments", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def scripts():
    return {name: _script(name) for name in ("w4a8_bench", "qkv_probe", "qdecode_sweep")}


# --- E1 -----------------------------------------------------------------------


@pytest.mark.parametrize("m", [1, 4, 9])
def test_e1_plain_matches_jax_w4a8_matmul(scripts, m):
    """Plain E1 on the port's K1 symmetric layout against the JAX
    ``w4a8_matmul`` on its own layout of the same levels, the scales
    rounded to bf16 on both sides; the activation prologue bit for bit."""
    e1 = scripts["w4a8_bench"]
    k, n = 512, 1024
    rng = np.random.default_rng(m)
    q = rng.integers(0, 16, (k, n)).astype(np.uint8)
    s = np.array(jnp.asarray(rng.standard_normal((k // 64, n)) * 0.01, jnp.float32)
                 .astype(jnp.bfloat16).astype(jnp.float32))
    x = jnp.asarray(rng.standard_normal((m, k)), jnp.bfloat16)
    q8, s8 = e1.w4a8_layout(q, s, 512)
    want = np.asarray(e1.w4a8_matmul(x, q8, s8, interpret=True))
    xt = torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16)
    x8, sx = TE1.quantize_activations(xt)
    jsx = jnp.max(jnp.abs(x), axis=1, keepdims=True) / 127.0  # the JAX prologue (w4a8_bench.py:94-98)
    jsx = jnp.where(jsx == 0, 1.0, jsx).astype(jnp.float32)
    jx8 = jnp.clip(jnp.round(x.astype(jnp.float32) / jsx), -127, 127).astype(jnp.int8)
    np.testing.assert_array_equal(x8.numpy(), np.asarray(jx8))
    np.testing.assert_array_equal(sx.numpy(), np.asarray(jsx)[:, 0])
    qweight = TW.pack_int4(torch.from_numpy(q))
    got = TE1.w4a8_matmul(xt, qweight, torch.from_numpy(s).to(torch.bfloat16))
    assert got.dtype == torch.float32 and got.shape == (m, n)
    np.testing.assert_allclose(got.numpy(), want, rtol=E1_TOL, atol=E1_TOL * np.abs(want).max())


def test_e1_is_the_k1_product_up_to_int8_activations():
    """With activations already on the int8 grid (x = sx * x8), E1 equals
    K1's plain version in symmetric mode, in f32."""
    rng = np.random.default_rng(11)
    k, n = 256, 128
    x8 = rng.integers(-127, 128, (3, k)).astype(np.float32)
    x8[:, 0] = 127  # every row's absmax is 127, so sx = 2**-3 exactly
    x = torch.from_numpy(x8 * 2.0**-3)
    qweight = TW.pack_int4(torch.from_numpy(rng.integers(0, 16, (k, n), dtype=np.uint8)))
    s = torch.from_numpy(rng.standard_normal((k // 64, n)).astype(np.float32) * 0.01).to(torch.bfloat16)
    np.testing.assert_allclose(TE1.w4a8_matmul(x, qweight, s).numpy(),
                               quant_matmul_plain(x, qweight, s).numpy(), rtol=1e-5, atol=1e-5)
    with pytest.raises(RuntimeError, match="no kernel"):
        TE1.w4a8_matmul(x.to("meta"), qweight.to("meta"), s.to("meta"))
    assert TE1.w4a8_matmul.launches == 0


# --- E2 / E3 ------------------------------------------------------------------

NL, B, H, KVH, D, L, BLK = 2, 1, 4, 2, 96, 256, 128
G = D // 32


def _cache(seed):
    """A random int4 cache in the TPU layout (payload (nl, b, kvh, D, L),
    D permuted; scales (nl, b, kvh, 4G, L) bf16-representable) and the
    port's view of the same bytes."""
    rng = np.random.default_rng(seed)
    payload = rng.integers(0, 256, (NL, B, KVH, D, L), dtype=np.uint8)
    scales = np.array(jnp.asarray(0.01 * rng.standard_normal((NL, B, KVH, 4 * G, L)), jnp.float32)
                      .astype(jnp.bfloat16).astype(jnp.float32))
    scales[:, :, :, G : 2 * G] += 0.05  # key biases off zero: the factored modes carry them
    port_payload, port_scales = from_jax_kv_cache(payload, scales)
    return jnp.asarray(payload), jnp.asarray(scales).astype(jnp.bfloat16), port_payload, port_scales


def _inputs(seed, lq):
    rng = np.random.default_rng(seed)
    q = (0.5 * rng.standard_normal((B, H, lq, D))).astype(np.float32)
    qt = torch.from_numpy(q).to(torch.bfloat16)
    qj = jnp.asarray(qt.float().numpy()).astype(jnp.bfloat16)[..., d_perm(D, G)]
    valid = np.ones((B, L), bool)
    valid[:, :5] = False  # left padding
    valid[:, 40] = False
    return qt, qj, valid


def _port(out_jax):
    return np.asarray(out_jax.astype(jnp.float32))[..., np.argsort(d_perm(D, G))]


# E3's mode -> the port's; the JAX script's u8 has no branch and runs fp32.
E3_MODES = [("fp32", "fp32"), ("u8", "fp32"), ("bf16", "bf16"), ("noscale", "convert"),
            ("nomul", "nomul"), ("fbias", "fbias"), ("mxu", "mxu")]


@pytest.mark.parametrize("lq", [1, 2])
@pytest.mark.parametrize("jax_mode,mode", E3_MODES, ids=[m for m, _ in E3_MODES])
def test_e3_variant_plain_matches_jax_qkv_attn(scripts, monkeypatch, jax_mode, mode, lq):
    e3 = scripts["qdecode_sweep"]
    jp, js, payload, scales = _cache(3)
    qt, qj, valid = _inputs(4 + lq, lq)
    offset = 200
    monkeypatch.setattr(e3, "pl", _InterpretPallas(e3.pl))
    for layer in range(NL):
        want = _port(e3.qkv_attn(qj, jp, js, jnp.asarray(valid), jnp.asarray(offset, jnp.int32), layer,
                                 scale=D**-0.5, block_k=BLK, mode=jax_mode))
        got = TKV.quantized_kv_attention_variant(qt, payload, scales, torch.from_numpy(valid), offset,
                                                 layer, D**-0.5, mode=mode)
        np.testing.assert_allclose(got.float().numpy(), want, **KERNEL_TOL, err_msg=f"layer {layer}")


@pytest.mark.parametrize("softmax,mode", [(True, "convert"), (False, "nosoftmax")])
def test_e2_variant_plain_matches_jax_probe_attention(scripts, monkeypatch, softmax, mode):
    e2 = scripts["qkv_probe"]
    jp, _, payload, scales = _cache(5)
    qt, qj, valid = _inputs(6, 1)
    offset = L - 1 if not softmax else 180
    monkeypatch.setattr(e2, "pl", _InterpretPallas(e2.pl))
    for layer in range(NL):
        want = _port(e2.probe_attention(qj, jp, jnp.asarray(valid), jnp.asarray(offset, jnp.int32), layer,
                                        scale=D**-0.5, block_k=BLK, softmax=softmax))
        got = TKV.quantized_kv_attention_variant(qt, payload, scales, torch.from_numpy(valid), offset,
                                                 layer, D**-0.5, mode=mode)
        # With no softmax the output is a sum of 256 signed terms score * v
        # that can cancel, and the JAX kernel rounds each score to bf16: its
        # error scales with the terms, so the limit is 2e-2 of the largest
        # output (about 12 bf16 ulps of the largest term).
        tol = KERNEL_TOL if softmax else dict(rtol=0, atol=2e-2 * np.abs(want).max())
        np.testing.assert_allclose(got.float().numpy(), want, **tol, err_msg=f"layer {layer}")


def test_variant_fp32_is_k4_and_modes_differ():
    """Mode fp32 is K4's plain version bit for bit; the factored modes differ
    from it by rounding only, the diagnostic modes by far more; an unknown
    mode and a device with no kernel raise."""
    _, _, payload, scales = _cache(7)
    qt, _, valid = _inputs(8, 3)
    valid_t = torch.from_numpy(valid)
    k4 = TKV.quantized_kv_attention(qt, payload, scales, valid_t, 100, 1, D**-0.5).float()
    outs = {m: TKV.quantized_kv_attention_variant(qt, payload, scales, valid_t, 100, 1, D**-0.5,
                                                  mode=m).float() for m in TKV.VARIANT_MODES}
    assert torch.equal(outs["fp32"], k4)
    for m in ("bf16", "fbias", "mxu"):
        assert 0 < float((outs[m] - k4).abs().max()) < 5e-2, m
    for m in ("convert", "nomul", "nosoftmax"):
        assert float((outs[m] - k4).abs().max()) > 1, m
    with pytest.raises(ValueError, match="mode"):
        TKV.quantized_kv_attention_variant(qt, payload, scales, valid_t, 100, 1, D**-0.5, mode="u8")
    with pytest.raises(RuntimeError, match="no kernel"):
        TKV.quantized_kv_attention_variant(qt.to("meta"), payload.to("meta"), scales.to("meta"),
                                           valid_t.to("meta"), 100, 1, D**-0.5, mode="mxu")
    assert TKV.quantized_kv_attention_variant.launches == 0


# --- the port's experiment entry points, on the CPU ----------------------------


def test_w4a8_bench_main_on_the_cpu(capsys):
    res = w4a8_bench.main(["--device", "cpu", "--k", "256", "--n", "512"])
    assert res["k"] == 256 and res["mean_rel_err"] < w4a8_bench.MAX_REL and res["rows"] == []
    assert "no timing" in capsys.readouterr().out


def test_qkv_probe_main_on_the_cpu(capsys):
    res = qkv_probe.main(["64", "--device", "cpu"])
    out = capsys.readouterr().out
    assert res["lmax"] == 64 and all(f"{name:8s} ran, finite" in out for name in ("full", "convert", "mxuonly"))


def test_qdecode_sweep_main_on_the_cpu(monkeypatch):
    monkeypatch.setenv("QD_LMAX", "64")
    monkeypatch.setenv("QD_MODES", ",".join(m for m, _ in E3_MODES))
    rows = qdecode_sweep.main(["--device", "cpu"])["rows"]
    assert len(rows) == len(E3_MODES) * len(qdecode_sweep.SPLITS)
    assert rows["fp32/split256"]["max_err"] == 0 and rows["u8/split1024"]["max_err"] == 0
    assert all(rows[f"{m}/split256"]["max_err"] < 5e-2 for m in ("bf16", "fbias", "mxu"))
    assert rows["noscale/split256"]["max_err"] > 1
    monkeypatch.setenv("QD_MODES", "fp32,nope")
    with pytest.raises(SystemExit, match="unknown"):
        qdecode_sweep.main(["--device", "cpu"])


@pytest.mark.parametrize("kernels_in_window", [(True,), (False, True), (False, False, False)])
def test_device_ms_profiles_again_a_window_with_no_kernel(monkeypatch, kernels_in_window):
    """The profiler now and then records no kernel of a window: device_ms
    profiles it again, and after three empty windows its time is None
    (a table then says "not measured") instead of 0."""
    import torch.profiler
    from torch.autograd import DeviceType

    from phi_3_vision_mlx_tpu_torch import experiments

    class Event:
        device_type, name, device_time_total = DeviceType.CUDA, "k1", 800.0  # us

    windows = []

    class Profile:
        def __init__(self, activities):
            windows.append(self)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def events(self):
            return [Event()] if kernels_in_window[len(windows) - 1] else []

    monkeypatch.setattr(torch.profiler, "profile", Profile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    calls = []
    out = experiments.device_ms(lambda: calls.append(1), 4)
    assert len(windows) == len(kernels_in_window) and len(calls) == 1 + 4 * len(windows)
    assert out == ({"all": 0.2, "k1": 0.2} if kernels_in_window[-1] else {"all": None})
    assert experiments.ms_text(out["all"]) == ("0.2000" if kernels_in_window[-1] else "not measured")


def test_experiments_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    for main in (w4a8_bench.main, qdecode_sweep.main):
        with pytest.raises(SystemExit, match="no CUDA device"):
            main([])


@pytest.mark.parametrize("kernels", ["E1", "K1,E1,E3", None, "K2F"])
def test_k4_ab_takes_its_kernels(monkeypatch, kernels):
    """``k4_ab`` runs its timing code once per tree, in the given order, for
    the named kernels (E1 among them; K1-K9 by default), and refuses an
    unknown one."""
    from phi_3_vision_mlx_tpu_torch.experiments import k4_ab

    runs = []

    class Done:
        returncode, stderr = 0, ""

        def __init__(self, kernels):
            self.stdout = json.dumps({"cases": {k: {} for k in kernels.split(",")}, "card": "stub"})

    def run(argv, cwd, **kw):
        runs.append((cwd, argv[-1]))
        return Done(argv[-1])

    monkeypatch.setattr(k4_ab.subprocess, "run", run)
    argv = (["--kernels", kernels] if kernels else []) + ["parent", ".", "parent"]
    results = k4_ab.main(argv)
    want = kernels or ",".join(k4_ab.DEFAULT)
    assert runs == [("parent", want), (".", want), ("parent", want)]
    assert [sorted(r["cases"]) for r in results] == [sorted(want.split(","))] * 3
    with pytest.raises(SystemExit):
        k4_ab.main(["--kernels", "E1,E9", "."])


def test_ptxas_report_parses_nvcc_output():
    """The register report reads each kernel's registers, stack frame,
    spills and static shared memory from ``nvcc -Xptxas -v`` output."""
    from phi_3_vision_mlx_tpu_torch.experiments import ptxas_report

    text = """ptxas info    : Compiling entry function '_Z3fooPf' for 'sm_90a'
ptxas info    : Function properties for _Z3fooPf
    24 bytes stack frame, 40 bytes spill stores, 32 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 24 bytes cumulative stack size, 16 bytes smem
ptxas info    : Compiling entry function '_Z3barv' for 'sm_90a'
ptxas info    : Function properties for _Z3barv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 32 registers, used 0 barriers
"""
    rows = ptxas_report.parse(text)
    assert [r["registers"] for r in rows] == [168, 32]
    assert [(r["stack"], r["spill_stores"], r["spill_loads"], r["smem"]) for r in rows] == [(24, 40, 32, 16),
                                                                                          (0, 0, 0, 0)]
    assert rows[0]["kernel"] in ("foo", "_Z3fooPf")  # demangled where c++filt is installed
