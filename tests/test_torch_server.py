"""The port's HTTP server against the JAX server, and the port's imports.

Each server gets its own preload of the same tiny quantized checkpoint (see
tests/test_torch_model.py:make_checkpoint) and must return the same
``responses`` for the same request, once with the dense KV cache and once
with the 4-bit cache (``use_quantized_cache``).  For the 4-bit pair the
port's server writes the JAX package's quantized cache entries in place of
its own (tests/test_torch_model.py:ReplayJaxCache explains why).  The import test runs in a subprocess so
that ``sys.modules`` starts clean.
"""

import ast
import glob
import json
import os
import shutil
import subprocess
import sys
import threading
import urllib.error
import urllib.request
from http.server import HTTPServer

import pytest

torch = pytest.importorskip("torch")

from test_torch_model import ReplayJaxCache, _jax_decode, make_checkpoint  # noqa: E402

from phi_3_vision_mlx_tpu.api import _load as jax_load  # noqa: E402
from phi_3_vision_mlx_tpu.serve.server import make_handler as jax_handler  # noqa: E402
from phi_3_vision_mlx_tpu_torch.api import _apply_chat_template  # noqa: E402
from phi_3_vision_mlx_tpu_torch.api import _load as torch_load  # noqa: E402
from phi_3_vision_mlx_tpu_torch.models import phi3 as TM  # noqa: E402
from phi_3_vision_mlx_tpu_torch.serve.server import make_handler as torch_handler  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def ports(tmp_path_factory):
    path = make_checkpoint(tmp_path_factory.mktemp("ckpt"), "tiny")
    jax_q = jax_load(path, use_quantized_cache=True)
    servers = {
        "jax": HTTPServer(("127.0.0.1", 0), jax_handler(jax_load(path))),
        "torch": HTTPServer(("127.0.0.1", 0), torch_handler(torch_load(path, device="cpu"))),
        "jax_q": HTTPServer(("127.0.0.1", 0), jax_handler(jax_q)),
        "torch_q": HTTPServer(("127.0.0.1", 0), torch_handler(
            torch_load(path, device="cpu", use_quantized_cache=True))),
    }
    threads = [threading.Thread(target=s.serve_forever, daemon=True) for s in servers.values()]
    for t in threads:
        t.start()
    yield {**{name: s.server_address[1] for name, s in servers.items()}, "jax_q_lm": jax_q}
    for s in servers.values():
        s.shutdown()
        s.server_close()
    for t in threads:
        t.join(timeout=30)


def post(port, data: bytes):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/completions", data=data,
        headers={"Content-Type": "application/json"},
    )
    try:
        with urllib.request.urlopen(req, timeout=300) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.mark.parametrize(
    "body",
    [
        {"prompt": "Hello there", "max_tokens": 12},
        {"prompt": ["Hello", "A second, longer prompt"], "max_tokens": 8},
        {"prompt": "Stop early", "max_tokens": 10, "stop": ">"},
    ],
)
def test_same_responses_as_jax_server(ports, body, monkeypatch):
    data = json.dumps(body).encode()
    n = 1 if isinstance(body["prompt"], str) else len(body["prompt"])
    jlm, jproc = ports["jax_q_lm"]
    _, jstate = _jax_decode(jlm, jproc(_apply_chat_template(body["prompt"])), body["max_tokens"])
    replay = ReplayJaxCache(jstate, jlm.cfg.kv_quant.bits)
    for jax_server, torch_server in (("jax", "torch"), ("jax_q", "torch_q")):
        if torch_server == "torch_q":
            monkeypatch.setattr(TM, "update_layer_chunk", replay)
        jcode, jpayload = post(ports[jax_server], data)
        tcode, tpayload = post(ports[torch_server], data)
        assert jcode == tcode == 200
        assert tpayload == jpayload, torch_server
        assert tpayload["model"] == "phi-3-vision-tpu"
        assert len(tpayload["responses"]) == n
    replay.check()


def test_error_paths(ports):
    for name in ("jax", "torch"):
        code, payload = post(ports[name], b"{not json")
        assert code == 500 and "error" in payload
        code, payload = post(ports[name], json.dumps({"prompt": "x", "stop": ""}).encode())
        assert code == 400 and "error" in payload
    # Sampling is not ported: the port says so instead of decoding greedily.
    code, payload = post(ports["torch"], json.dumps({"prompt": "x", "temperature": 0.7}).encode())
    assert code == 500 and "sampling" in payload["error"]


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import phi_3_vision_mlx_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import phi_3_vision_mlx_tpu_torch.serve.server, phi_3_vision_mlx_tpu_torch.api, chip_smoke\n"
        "from phi_3_vision_mlx_tpu_torch.experiments import qdecode_sweep, qkv_probe, w4a8_bench\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.'))\n"
        "assert not bad, bad\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k == 'phi_3_vision_mlx_tpu' or k.startswith('phi_3_vision_mlx_tpu.'))\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0 and "clean" in out.stdout, out.stderr


def _imported_modules(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _is_jax_side(module):
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "phi_3_vision_mlx_tpu")


def test_chip_smoke_and_port_import_no_jax_package_directly():
    """No file of the port, and not chip_smoke.py, imports jax or any module
    of the JAX package: the port keeps its own copies of the host modules."""
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    paths += glob.glob(os.path.join(ROOT, "phi_3_vision_mlx_tpu_torch", "**", "*.py"), recursive=True)
    experiments = {os.path.basename(p) for p in paths if os.sep + "experiments" + os.sep in p}
    assert {"__init__.py", "w4a8_bench.py", "qkv_probe.py", "qdecode_sweep.py"} <= experiments
    for path in paths:
        mods = [m for m in _imported_modules(path) if _is_jax_side(m)]
        assert not mods, f"{os.path.relpath(path, ROOT)} imports {mods}"


def test_chip_smoke_fails_without_a_card_or_the_repo(tmp_path):
    """No CUDA device (this host), or ``chip_smoke.py`` alone in a directory:
    a non-zero exit and no result line."""
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), alone)
    for cwd, script in ((ROOT, "chip_smoke.py"), (str(tmp_path), str(alone))):
        out = subprocess.run([sys.executable, script], cwd=cwd, capture_output=True, text=True,
                             timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
