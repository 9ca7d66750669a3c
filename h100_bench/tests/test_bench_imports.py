"""What a run loads: never JAX, Flax or the JAX package (compared by whole
top-level names, since the port's name begins with the JAX package's), and
the reference nothing of the program either."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from h100_bench import harness

ROOT = Path(__file__).resolve().parents[2]
REFERENCE = sorted((ROOT / "h100_bench" / "reference").glob("*.py"))
PROGRAM = {"jax", "jaxlib", "flax", "phi_3_vision_mlx_tpu", "phi_3_vision_mlx_tpu_torch"}


@pytest.mark.parametrize("path", REFERENCE, ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    assert not tops & PROGRAM
    assert tops <= {"__future__", "math", "re", "numpy", "torch"}


def test_reference_and_check_load_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, sys.argv[1]);"
            "import h100_bench.check, h100_bench.weights, h100_bench.traffic, h100_bench.flops;"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)], capture_output=True, text=True,
                         timeout=120, check=True).stdout
    assert not set(eval(out)) & PROGRAM


def test_a_whole_run_loads_no_jax():
    code = ("import sys, time; sys.path.insert(0, sys.argv[1]);"
            "import torch; torch.set_num_threads(4);"
            "from h100_bench import harness; from h100_bench.tests import tiny;"
            "out = harness.run('mini-w4.chat', 9, 1.5, True, time.perf_counter(), 'cpu',"
            " tiny.parts('mini-w4.chat'));"
            "print(out['correct'], harness.forbidden_modules(),"
            " 'phi_3_vision_mlx_tpu_torch' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)], capture_output=True, text=True,
                         timeout=300, check=True).stdout.strip().splitlines()[-1]
    assert out == "True [] True"


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "phi_3_vision_mlx_tpu_torch_like", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping_like", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "phi_3_vision_mlx_tpu.core", sys)
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert harness.forbidden_modules() == ["jax.numpy", "phi_3_vision_mlx_tpu.core"]
