"""HTTP completion server
(counterpart of ``phi_3_vision_mlx_tpu/serve/server.py``).

POST /v1/completions with {"prompt": str | [str], "max_tokens": int,
optional "stop", "temperature", "top_p", "top_k", "min_p", "seed"} ->
{"model", "responses": [...]}, the same JSON as the JAX server.  Decoding
is greedy unless "temperature" > 0, which samples under the other knobs
from "seed" (on the continuous server a request without one draws from the
engine's seed and its id).  ``serve(quantize_cache=True)`` loads
the model with the 4-bit KV cache (keyword arguments of ``serve`` go to
``api.load``; as in the JAX server there is no command-line flag for it).

``serve(continuous=True)`` (``--continuous``) serves through
:class:`ContinuousScheduler`: requests join a running decode batch of
``slots`` lanes (``engine/batching.py``), over a shared page pool with
``paged=True`` (``engine/paging.py``, kernels K6/K7 on the card).  There a
body may carry ``"images"`` (paths or URLs, decoded with ``fetch_image``)
for a single prompt, which is chat-templated with its ``<|image_i|>`` tags
as ``api.generate`` does; several prompts with images get a 400.  Image
requests prefill one at a time and are never batched.  The single-stream
handler takes no images, as the JAX one does not either.  ``--spec-k K``
(``serve(spec_k=K)``) makes every decode chunk of the continuous server
verify passes of K prompt-lookup drafts a slot (``engine/speculative.py``;
on the card K is at most 15 with ``--paged``).

``--blind`` and ``--quantize`` are the JAX server's flags: ``--blind``
selects the text model (``models/phi3_mini_128k``), its absence the vision
model (``models/phi3_v``), and ``--quantize`` the 4-bit checkpoint of
either (``..._Q``).

Example:
    python -m phi_3_vision_mlx_tpu_torch.serve.server --blind --quantize --port 8000
    python -m phi_3_vision_mlx_tpu_torch.serve.server --continuous --paged --slots 4 --window 4096
    python -m phi_3_vision_mlx_tpu_torch.serve.server --blind --continuous --paged --spec-k 7
    curl -X POST http://localhost:8000/v1/completions \\
      -H "Content-Type: application/json" \\
      -d '{"prompt": "What is shown?", "images": ["cat.png"], "max_tokens": 64}'
"""

from __future__ import annotations

import json
import threading
import weakref
from collections import deque
from http.server import BaseHTTPRequestHandler, HTTPServer, ThreadingHTTPServer

from ..engine.stream import validate_stops

MODEL_NAME = "phi-3-vision-tpu"


def _send_json(handler, code: int, obj) -> None:
    payload = json.dumps(obj).encode()
    handler.send_response(code)
    handler.send_header("Content-Type", "application/json")
    handler.send_header("Content-Length", str(len(payload)))
    handler.end_headers()
    handler.wfile.write(payload)


def make_handler(preload):
    from ..api import generate

    class CompletionHandler(BaseHTTPRequestHandler):
        def do_POST(self):
            if self.path != "/v1/completions":
                self.send_error(404)
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(length) or b"{}")
                try:
                    stop = validate_stops(body.get("stop"))
                except ValueError as e:
                    _send_json(self, 400, {"error": str(e)})
                    return
                temperature = float(body.get("temperature", 0.0))
                responses = generate(
                    body.get("prompt", ""),
                    preload=preload,
                    max_tokens=int(body.get("max_tokens", 128)),
                    verbose=False,
                    stream=False,
                    mute=True,
                    sample=temperature > 0,
                    temperature=temperature,
                    top_p=float(body.get("top_p", 1.0)),
                    top_k=int(body.get("top_k", 0)),
                    min_p=float(body.get("min_p", 0.0)),
                    seed=int(body.get("seed", 0)),
                    stop=stop,
                )
                if isinstance(responses, str):
                    responses = [responses]
                _send_json(self, 200, {"model": MODEL_NAME, "responses": responses})
            except Exception as e:  # report errors as JSON, keep serving
                _send_json(self, 500, {"error": str(e)})

        def log_message(self, fmt, *args):
            pass

    return CompletionHandler


class ContinuousScheduler:
    """Thread-safe front end over the slot engine (``paged=False``) or the
    paged engine (``paged=True``).

    HTTP handler threads call :meth:`complete`.  An admission thread drains
    queued requests, up to ``admit_batch`` at a time, into one batched
    prefill (``engine.prepare_many``) outside the lock, then adopts them
    under it (image requests prefill one at a time, each with its own
    error); a pump thread steps the engine by chunks of ``chunk`` tokens,
    pipelined (``step_pipelined``) unless ``pipelined=False``, and runs the
    preempted requests' recompute prefills outside the lock.  Both threads
    launch on the default stream, so launch order orders their work.  The
    engine's decode graphs (greedy and sampled, of the step or of the
    verify pass) are captured here, before either thread starts: no
    admission prefill (its allocations, its launches on the default
    stream) can overlap a capture, and every decode step is a
    replay on the default stream.  An engine error fails the requests it
    owns, not the pump.

    The two threads hold the scheduler by weak reference only (``_serve``)
    and wait for work without it, at most ``IDLE_WAIT`` seconds at a time:
    once its last user drops it, they end within one wait, and the engine
    with its cache and graphs is freed (a thread holding it would keep it
    alive for the life of the process).
    """

    IDLE_WAIT = 0.25  # seconds a thread waits for work before it looks for its scheduler again

    def __init__(self, lm, processor, slots: int = 4, window: int = 1024, paged: bool = False,
                 admit_batch: int = 0, chunk: int = 8, pipelined: bool = True, **engine_kw):
        if paged:
            from ..engine.paging import PagedBatchEngine as Engine
        else:
            from ..engine.batching import BatchEngine as Engine
        if lm.device.type == "cuda":
            from ..ops.kernels import _build

            _build.library()  # build once, before two threads launch kernels
        self.engine = Engine(lm, processor, slots=slots, window=window, **engine_kw)
        self.engine.capture()
        # Resumes are prefilled here, outside the lock, not inside step().
        self.engine.resume_in_step = False
        self.admit_batch = admit_batch or min(8, max(2, slots))
        self.chunk, self.pipelined = chunk, pipelined
        self._cv = threading.Condition()
        self._tickets = deque()
        ref = weakref.ref(self)
        for turn in (ContinuousScheduler._admission_turn, ContinuousScheduler._pump_turn):
            threading.Thread(target=_serve, args=(ref, turn), daemon=True,
                             name=f"ContinuousScheduler.{turn.__name__}").start()

    def complete(self, prompt: str, max_tokens: int, temperature: float = 0.0, top_p: float = 1.0,
                 top_k: int = 0, min_p: float = 0.0, stop=None, images=None, seed=None) -> str:
        """Serve one request and return its text.  ``images``: decoded
        images for the prompt's ``<|image_i|>`` tags (vision model)."""
        opts = dict(max_tokens=max_tokens, temperature=temperature, top_p=top_p, top_k=top_k,
                    min_p=min_p, stop=stop, seed=seed)
        ticket = {"prompt": prompt, "images": images, "opts": opts, "rid": None, "error": None}
        with self._cv:
            self._tickets.append(ticket)
            self._cv.notify_all()
            while ticket["rid"] is None and ticket["error"] is None:
                self._cv.wait()
            if ticket["error"] is not None:
                raise RuntimeError(ticket["error"])
            req = self.engine.requests[ticket["rid"]]
            while not req.done:
                self._cv.wait()
            return self.engine.result(ticket["rid"])  # raises if the request failed

    def _admission_turn(self):
        """Admit one batch of queued tickets; with none queued, return what
        to wait on (``_serve``)."""
        with self._cv:
            if not self._tickets:
                return self._cv, self._tickets.__len__
            n = min(len(self._tickets), self.admit_batch)
            batch = [self._tickets.popleft() for _ in range(n)]
        # Text tickets share one batched prefill; image tickets prefill
        # one at a time.  Errors stay per ticket: a bad image does not
        # fail the text requests of its batch.
        text = [t for t in batch if not t["images"]]
        pairs, failed = [], []
        if text:
            try:
                pairs += zip(text, self.engine.prepare_many([t["prompt"] for t in text],
                                                            [t["opts"] for t in text]))
            except Exception as e:
                failed += [(t, f"{type(e).__name__}: {e}") for t in text]
        for t in batch:
            if t["images"]:
                try:
                    pairs.append((t, self.engine.prepare(t["prompt"], images=t["images"], **t["opts"])))
                except Exception as e:
                    failed.append((t, f"{type(e).__name__}: {e}"))
        if failed:
            with self._cv:
                for t, msg in failed:
                    t["error"] = msg
                self._cv.notify_all()
        for t, p in pairs:
            with self._cv:
                try:
                    while not self.engine.can_admit(p):
                        self._cv.wait()
                    t["rid"] = self.engine.admit(p)
                except Exception as e:
                    t["error"] = f"{type(e).__name__}: {e}"
                self._cv.notify_all()
        return None

    def _pump_turn(self):
        """Step the engine by one chunk; with nothing pending, return what
        to wait on (``_serve``)."""
        with self._cv:
            if not self.engine.pending():
                return self._cv, self.engine.pending
            resume = getattr(self.engine, "resume_candidate", None)
            rid = resume() if resume else None
        prepared = None
        if rid is not None:
            try:
                prepared = self.engine.prepare_resume(rid)
            except Exception as e:
                with self._cv:
                    self.engine._fail_request(self.engine.requests[rid], f"{type(e).__name__}: {e}")
                    if self.engine.preempted and self.engine.preempted[0] == rid:
                        self.engine.preempted.pop(0)
                    self._cv.notify_all()
        with self._cv:
            try:
                if prepared is not None:
                    self.engine.admit_resume(prepared)
                if self.pipelined:
                    # Ticking while pending() also collects the last
                    # in-flight chunk once by_slot is empty.
                    self.engine.step_pipelined(self.chunk)
                elif self.engine.by_slot:
                    self.engine.step(self.chunk)
            except Exception as e:  # fail the owners, keep the pump alive
                self.engine.fail_all_active(f"{type(e).__name__}: {e}")
            self._cv.notify_all()
        return None


def _serve(ref, turn) -> None:
    """Run ``turn(scheduler)`` while ``ref`` (a weak reference) still
    reaches the scheduler.  A turn with no work returns (condition, ready):
    the thread then waits, holding no reference to the scheduler (two
    threads each waiting with one would keep it alive between them), up to
    ``IDLE_WAIT`` seconds or until ``ready()`` under the condition."""
    while True:
        scheduler = ref()
        if scheduler is None:
            return
        idle = turn(scheduler)
        del scheduler
        if idle is not None:
            cv, ready = idle
            with cv:
                if not ready():
                    cv.wait(ContinuousScheduler.IDLE_WAIT)
            del cv, ready, idle


def make_continuous_handler(scheduler: ContinuousScheduler):
    class ContinuousHandler(BaseHTTPRequestHandler):
        def do_POST(self):
            if self.path != "/v1/completions":
                self.send_error(404)
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(length) or b"{}")
                prompts = body.get("prompt", "")
                prompts = [prompts] if isinstance(prompts, str) else prompts
                try:
                    stop = validate_stops(body.get("stop"))
                except ValueError as e:
                    _send_json(self, 400, {"error": str(e)})
                    return
                max_tokens = int(body.get("max_tokens", 128))
                seed = body.get("seed")
                knobs = dict(temperature=float(body.get("temperature", 0.0)),
                             top_p=float(body.get("top_p", 1.0)), top_k=int(body.get("top_k", 0)),
                             min_p=float(body.get("min_p", 0.0)),
                             seed=None if seed is None else int(seed))
                images = body.get("images")
                if images:
                    if len(prompts) != 1:
                        _send_json(self, 400, {"error": "images require a single prompt"})
                        return
                    from ..api import _apply_chat_template

                    prompt, loaded = _apply_chat_template(prompts[0], list(images), verbose=False)
                    responses = [scheduler.complete(prompt, max_tokens, stop=stop, images=loaded,
                                                    **knobs)]
                else:
                    responses = [scheduler.complete(p, max_tokens, stop=stop, **knobs) for p in prompts]
                _send_json(self, 200, {"model": MODEL_NAME, "responses": responses})
            except Exception as e:
                _send_json(self, 500, {"error": str(e)})

        def log_message(self, fmt, *args):
            pass

    return ContinuousHandler


def serve(host: str = "127.0.0.1", port: int = 8000, preload=None, continuous: bool = False,
          slots: int = 4, window: int = 1024, paged: bool = False, spec_k: int = 0,
          pipeline_depth: int = 1, **load_kwargs):
    from ..api import load

    preload = preload or load(**load_kwargs)
    if continuous:
        scheduler = ContinuousScheduler(*preload, slots=slots, window=window, paged=paged,
                                        spec_k=spec_k, pipeline_depth=pipeline_depth)
        httpd = ThreadingHTTPServer((host, port), make_continuous_handler(scheduler))
        print(f"Serving (continuous batching, {slots} slots x {window} window) "
              f"on http://{host}:{port}/v1/completions")
    else:
        httpd = HTTPServer((host, port), make_handler(preload))
        print(f"Serving on http://{host}:{port}/v1/completions")
    httpd.serve_forever()


def build_parser():
    """The command line of the JAX server.  ``--blind`` selects the text
    model, the vision model without it; ``--quantize`` picks the 4-bit
    checkpoint."""
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--blind", action="store_true", help="the text model (default: the vision model)")
    ap.add_argument("--quantize", action="store_true", help="the 4-bit checkpoint")
    ap.add_argument("--continuous", action="store_true", help="continuous batching over a slot pool")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--window", type=int, default=1024)
    ap.add_argument("--paged", action="store_true", help="page-pool KV (engine/paging.py)")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="per-slot speculative decoding: verify K prompt-lookup drafts a pass")
    ap.add_argument("--pipeline-depth", type=int, default=1,
                    help="decode chunks kept in flight by the pump")
    return ap


def main(argv=None) -> None:
    a = build_parser().parse_args(argv)
    serve(a.host, a.port, blind_model=a.blind, quantize_model=a.quantize, continuous=a.continuous,
          slots=a.slots, window=a.window, paged=a.paged, spec_k=a.spec_k,
          pipeline_depth=a.pipeline_depth)


if __name__ == "__main__":
    main()
