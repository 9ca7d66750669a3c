"""The port's benchmark (``phi_3_vision_mlx_tpu_torch/bench.py``), profiling
hooks (``utils/profiler.py``, ``PHI3V_TPU_STEP_LOG``) and chat UI
(``serve/ui.py``) against the JAX package's, on the CPU.

The benchmark runs offline as the JAX one does in tests/test_offline_setup.py:
2-layer narrow random checkpoints written by the port's ``_setup`` (the
vision preset's CLIP tower shrunk as in tests/test_torch_api.py), a LoRA
trained for each of the four model dirs, then the 4 x 3 table.  No module
named ``requests`` imports (as on the card's machine) and every socket
refuses, so the Met Museum URL fails at once and nothing reaches a network.
"""

import json
import os
import socket
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_api import SMALL_TOWER  # noqa: E402
from test_torch_model import VOCAB  # noqa: E402
from test_torch_speculative import one_thread  # noqa: E402,F401  (autouse: one torch thread)

from phi_3_vision_mlx_tpu import bench as JB  # noqa: E402
from phi_3_vision_mlx_tpu.core import weights as JW  # noqa: E402
from phi_3_vision_mlx_tpu.serve import ui as JUI  # noqa: E402
from phi_3_vision_mlx_tpu.utils import profiler as JPROF  # noqa: E402
from phi_3_vision_mlx_tpu_torch import api as TAPI  # noqa: E402
from phi_3_vision_mlx_tpu_torch import bench as TB  # noqa: E402
from phi_3_vision_mlx_tpu_torch.serve import ui as TUI  # noqa: E402
from phi_3_vision_mlx_tpu_torch.utils import media as TMEDIA  # noqa: E402
from phi_3_vision_mlx_tpu_torch.utils import profiler as TPROF  # noqa: E402

# tests/test_offline_setup.py's narrow widths for the random checkpoints.
NARROW = {"hidden_size": 256, "intermediate_size": 512, "num_attention_heads": 8,
          "num_key_value_heads": 8}
METHODS = {"vanilla", "q_model", "q_cache", "lora"}


@pytest.fixture
def offline(tmp_path, monkeypatch):
    """A fresh working directory, the random-checkpoint variables, no
    ``requests`` and no sockets (each attempt is recorded, then refused)."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("PHI3V_TPU_ALLOW_RANDOM", "1")
    monkeypatch.setenv("PHI3V_TPU_RANDOM_LAYERS", "2")
    monkeypatch.setenv("PHI3V_TPU_RANDOM_OVERRIDES", json.dumps(NARROW))
    monkeypatch.setitem(sys.modules, "requests", None)
    attempts = []

    def no_network(*a, **kw):
        attempts.append(a[:2])
        raise OSError(f"no network in the tests: {a[:2]}")

    monkeypatch.setattr(socket.socket, "connect", no_network)
    monkeypatch.setattr(socket, "create_connection", no_network)
    create = TAPI.W.create_random_checkpoint

    def small_tower(path, preset_name, **overrides):
        if preset_name == "phi35_vision":
            overrides.update(SMALL_TOWER)
        return create(path, preset_name, **overrides)

    monkeypatch.setattr(TAPI.W, "create_random_checkpoint", small_tower)
    return attempts


def test_benchmark_offline(offline, capsys):
    """``benchmark(blind_model=True, train_first=True, max_tokens=4,
    dataset_path="synthetic")`` on the CPU: both random pairs written, an
    adapter trained for each model dir, benchmark.json with 4 configs x 3
    tasks and every generation rate above 0, and the table the JAX
    ``_format_benchmark`` prints for that json."""
    results = TB.benchmark(blind_model=True, train_first=True, max_tokens=4,
                           dataset_path="synthetic", device="cpu")
    printed = capsys.readouterr().out
    with open("benchmark.json") as f:
        data = json.load(f)
    assert set(results) == set(data) == METHODS and data == json.loads(json.dumps(results))
    for rows in data.values():
        assert [r[0] for r in rows] == [0, 1, 2]
        assert all(p_tps > 0 and g_tps > 0 for _, p_tps, g_tps in rows)
    for path in (TAPI.PATH_ORIGINAL_PHI3_VISION, TAPI.PATH_QUANTIZED_PHI3_VISION,
                 TAPI.PATH_ORIGINAL_PHI3_BLIND, TAPI.PATH_QUANTIZED_PHI3_BLIND):
        assert os.path.exists(os.path.join(TAPI._get_adapter_path(path), "adapters.safetensors"))
    JB._format_benchmark("benchmark.json")
    table = capsys.readouterr().out
    assert table.strip() and printed.endswith(table)
    assert offline == []  # nothing tried a socket


def test_benchmark_falls_back_to_the_local_image(offline, monkeypatch):
    """The Met Museum URL fails at once offline (no ``requests``, no
    socket) and the image task gets the local test image; the text tasks
    keep their prompts (``load`` and ``generate`` stubbed: the flow only)."""
    for path in (TAPI.PATH_ORIGINAL_PHI3_VISION, TAPI.PATH_ORIGINAL_PHI3_BLIND):
        os.makedirs(path)
    calls = []
    monkeypatch.setattr(TAPI, "load", lambda **kw: ("lm", "proc"))

    def generate(*args, **kw):
        calls.append(args)
        return 1.0, 2.0

    monkeypatch.setattr(TAPI, "generate", generate)
    with pytest.raises(ValueError, match="Failed to load image"):
        TAPI._load_image(TB.BENCH_PROMPTS[1][1])
    results = TB.benchmark(train_first=False, max_tokens=4, device="cpu")
    assert len(calls) == 12 and results["lora"] == [[0, 1.0, 2.0], [1, 1.0, 2.0], [2, 1.0, 2.0]]
    image = calls[1][1]
    assert isinstance(image, TMEDIA.ArrayImage)
    np.testing.assert_array_equal(np.asarray(image), np.asarray(TB._local_test_image()))
    assert calls[0] == TB.BENCH_PROMPTS[0] and calls[2] == TB.BENCH_PROMPTS[2]
    assert offline == []


def test_format_benchmark_matches_jax(tmp_path, capsys):
    """The same benchmark.json prints the same table in both packages."""
    rng = np.random.default_rng(0)
    data = {m: [[i, float(rng.uniform(1, 500)), float(rng.uniform(1, 500))] for i in range(3)]
            for m in ("vanilla", "q_model", "q_cache", "lora")}
    path = str(tmp_path / "benchmark.json")
    with open(path, "w") as f:
        json.dump(data, f)
    JB._format_benchmark(path)
    want = capsys.readouterr().out
    TB._format_benchmark(path)
    assert capsys.readouterr().out == want and "tps" in want
    assert (TB._TASKS, TB._METHODS) == (JB._TASKS, JB._METHODS)


def test_bench_prompts_match_jax():
    """The port's copy of the prompts equals the JAX list: 15 batch prompts
    from 16 literals, the URL, the text prompt."""
    assert TB.BENCH_PROMPTS == JB.BENCH_PROMPTS
    assert len(TB.BENCH_PROMPTS[2][0]) == 15


def test_local_test_image_matches_the_jax_png(tmp_path, monkeypatch):
    """The port's in-memory test image has the pixels of the PNG the JAX
    package writes (read here with Pillow; the port needs none)."""
    from PIL import Image

    monkeypatch.chdir(tmp_path)
    with Image.open(JB._local_test_image()) as png:
        want = np.asarray(png.convert("RGB"))
    img = TMEDIA.fetch_image(TB._local_test_image())
    assert img.size == (640, 480)
    np.testing.assert_array_equal(np.asarray(img.convert("RGB")), want)
    assert os.listdir(tmp_path) == ["bench_test_image.png"]  # the JAX side's file only


# -- profiler -------------------------------------------------------------------


def test_step_timer_summary_matches_jax():
    """The same samples give the same summary (and an empty one none)."""
    samples = list(np.random.default_rng(3).uniform(1e-4, 5e-2, 37))
    jt, tt = JPROF.StepTimer(), TPROF.StepTimer()
    assert tt.summary() == jt.summary() == {}
    jt.samples, tt.samples = list(samples), list(samples)
    assert tt.summary() == jt.summary()
    tt.tick()
    tt.tick()
    assert len(tt.samples) == 38 and tt.samples[-1] >= 0


def test_trace_writes_a_cpu_trace(tmp_path):
    """``trace`` writes a Chrome trace of the body under ``log_dir``, with
    the ``annotate`` range in it."""
    with TPROF.trace(str(tmp_path / "tr")) as log_dir:
        with TPROF.annotate("phi3v_probe"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    files = os.listdir(log_dir)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(os.path.join(log_dir, files[0])) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "phi3v_probe" for e in events)


def test_step_log_through_generate(tmp_path, monkeypatch):
    """``PHI3V_TPU_STEP_LOG`` makes the port's ``generate`` write the step
    summary (the JAX one's keys, one sample per decode chunk)."""
    path = str(tmp_path / "ckpt")
    JW.create_random_checkpoint(path, "tiny", vocab_size=VOCAB)
    preload = TAPI._load(path, device="cpu")
    log = str(tmp_path / "steps.json")
    monkeypatch.setenv("PHI3V_TPU_STEP_LOG", log)
    TAPI.generate("Tell me about lighthouses.", preload=preload, max_tokens=20, verbose=False,
                  stream=False, mute=True)
    with open(log) as f:
        summary = json.load(f)
    jt = JPROF.StepTimer()
    jt.samples = [0.1]
    assert set(summary) == set(jt.summary()) and summary["n"] >= 1


# -- chat UI ----------------------------------------------------------------------


class FakeAgent:
    def __init__(self):
        self.seen = []

    def __call__(self, prompt, images=None):
        self.seen.append((prompt, images))
        n = len(self.seen)
        return {"responses": [f"turn {n}<|end|>\njunk", "\n\nsecond\n"] if n == 2 else f"hi {n}<|end|>x",
                "files": ["plot.png", None] if n == 1 else None}

    def end(self):
        self.seen.append("end")


def test_chat_session_matches_jax():
    """The port's ChatSession gives the JAX one's history turn for turn
    (uploads, <|end|> trimming, blank lines dropped, files, a fresh turn
    after each response, reset)."""
    sessions = [(ui.ChatSession(FakeAgent())) for ui in (JUI, TUI)]
    turns = [("what is this?", ["/tmp/img.png", "/tmp/b.png"]), ("and now?", []), (None, ["/tmp/c.png"])]
    for text, files in turns:
        if text is None:
            histories = [s.add_user_message("last", files) for s in sessions]
        else:
            histories = [s.add_user_message(text, files) for s in sessions]
        assert histories[0] == histories[1]
        assert sessions[0].run_agent() == sessions[1].run_agent()
    assert sessions[0].agent.seen == sessions[1].agent.seen
    assert sessions[1].agent.seen[0] == ("what is this?", ["/tmp/img.png", "/tmp/b.png"])
    assert sessions[1].agent.seen[1] == ("and now?", None)
    assert sessions[0].reset() == sessions[1].reset() == [] and sessions[1].agent.seen[-1] == "end"


def test_chat_ui_needs_gradio(monkeypatch):
    """Without gradio ``chat_ui`` raises ``ImportError`` at call time, as the
    JAX one does; importing the module needs nothing."""
    monkeypatch.setitem(sys.modules, "gradio", None)
    for ui in (JUI, TUI):
        with pytest.raises(ImportError, match="chat_ui requires gradio"):
            ui.chat_ui(agent=FakeAgent())
