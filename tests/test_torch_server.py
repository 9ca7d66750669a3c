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
from http.server import HTTPServer, ThreadingHTTPServer

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
    _, jstate = _jax_decode(jlm, jproc(_apply_chat_template(body["prompt"])[0]), body["max_tokens"])
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
    # A sampled request answers from both packages.
    for name in ("jax", "torch"):
        body = {"prompt": "x", "temperature": 0.7, "top_p": 0.9, "seed": 3, "max_tokens": 4}
        code, payload = post(ports[name], json.dumps(body).encode())
        assert code == 200 and len(payload["responses"]) == 1


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


def test_port_imports_no_pil_at_module_level():
    """No module of the port, and not chip_smoke.py, loads Pillow when it is
    imported (the card's machine has none): the raw-image path reads only
    ``.size`` and ``.convert``, and ``fetch_image`` and the host resize
    import PIL where they run."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import phi_3_vision_mlx_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(k for k in sys.modules if k == 'PIL' or k.startswith('PIL.'))\n"
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


# --- image requests on the continuous server --------------------------------


@pytest.fixture(scope="module")
def vision_pair(tmp_path_factory):
    """(JAX (lm, proc), port (lm, proc)) over one 4-bit ``tiny_vision``
    checkpoint (tests/test_torch_vision.py:vision_checkpoint), 4 crops."""
    from test_torch_vision import load_pair, vision_checkpoint

    return load_pair(vision_checkpoint(tmp_path_factory.mktemp("vckpt"), "tv", q_bits=4))


def _scheduler_texts(scheduler, requests):
    """Submit ``requests`` ((prompt, images) pairs) to ``scheduler.complete``
    from concurrent threads; returns the texts in order."""
    texts = [None] * len(requests)

    def worker(i, prompt, images):
        texts[i] = scheduler.complete(prompt, 10, images=images)

    threads = [threading.Thread(target=worker, args=(i, *r)) for i, r in enumerate(requests)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    return texts


@pytest.mark.parametrize("paged", [False, True], ids=["slots", "paged"])
def test_continuous_scheduler_serves_image_and_text_like_jax(vision_pair, paged):
    """An image request and a text request admitted together: every answer
    is the JAX scheduler's, with the slot cache and with the page pool."""
    from test_torch_vision import images_for

    from phi_3_vision_mlx_tpu.serve.server import ContinuousScheduler as JSched
    from phi_3_vision_mlx_tpu_torch.serve.server import ContinuousScheduler as TSched

    (jlm, jproc), (tlm, tproc) = vision_pair
    image_prompt, imgs = _apply_chat_template("What is in the picture?", images_for(1))
    requests = [(image_prompt, imgs), (_apply_chat_template("Tell me about tides.")[0], None)]
    kw = dict(slots=2, window=1024, paged=paged)
    want = _scheduler_texts(JSched(jlm, jproc, **kw), requests)
    got = _scheduler_texts(TSched(tlm, tproc, **kw), requests)
    assert got == want and all(got)


def test_image_request_is_never_preempted(vision_pair):
    """A text request (older) and an image request (younger) on a pool one
    page short of both growing: the text request is preempted, though the
    image request is the youngest, and resumes; both streams are the JAX
    engine's, and the image request was never in the resume queue."""
    from test_torch_vision import images_for

    from phi_3_vision_mlx_tpu.engine.paging import PagedBatchEngine as JPaged
    from phi_3_vision_mlx_tpu_torch.engine.paging import PagedBatchEngine as TPaged

    (jlm, jproc), (tlm, tproc) = vision_pair
    image_prompt, imgs = _apply_chat_template("What is in the picture?", images_for(1))
    text_prompt = _apply_chat_template("Short text.")[0]
    streams = []
    for Engine, lm, proc in ((JPaged, jlm, jproc), (TPaged, tlm, tproc)):
        eng = Engine(lm, proc, slots=2, window=1024, page_size=64, pool_pages=15)
        text = eng.submit(text_prompt, max_tokens=12)
        img = eng.submit(image_prompt, max_tokens=12, images=imgs)
        assert eng.requests[img].has_images and not eng.requests[text].has_images
        seen = set()
        while eng.pending():
            eng.step(4)
            seen.update(eng.preempted)
        streams.append((eng.tokens(text), eng.tokens(img)))
        assert seen == {text}
    assert streams[1] == streams[0]
    assert eng.preemptions > 0 and len(eng._free_pages) == eng.pool_pages


def test_several_prompts_with_images_get_400(vision_pair, tmp_path):
    """The continuous handler takes ``"images"`` (paths, decoded by
    ``fetch_image``) for one prompt, chat-templated with its tags, and
    answers 400 for several prompts with images."""
    from test_torch_vision import images_for

    from phi_3_vision_mlx_tpu_torch.serve import server as TSV

    _, (tlm, tproc) = vision_pair
    path = str(tmp_path / "img.png")
    images_for(1)[0].save(path)
    scheduler = TSV.ContinuousScheduler(tlm, tproc, slots=2, window=1024)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), TSV.make_continuous_handler(scheduler))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        port = httpd.server_address[1]
        code, payload = post(port, json.dumps({"prompt": ["a", "b"], "images": [path]}).encode())
        assert code == 400 and "single prompt" in payload["error"]
        body = {"prompt": "What is in the picture?", "images": [path], "max_tokens": 10}
        code, payload = post(port, json.dumps(body).encode())
        prompt, imgs = _apply_chat_template(body["prompt"], [path])
        assert code == 200 and payload["responses"] == [scheduler.complete(prompt, 10, images=imgs)]
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
