"""Single-stream HTTP completion server
(counterpart of ``phi_3_vision_mlx_tpu/serve/server.py``).

POST /v1/completions with {"prompt": str | [str], "max_tokens": int,
optional "stop"} -> {"model", "responses": [...]}, the same JSON as the JAX
server.  Decoding is greedy; a request with "temperature" > 0 gets a 500
JSON error until sampling is ported.  ``serve(quantize_cache=True)`` loads
the model with the 4-bit KV cache (keyword arguments of ``serve`` go to
``api.load``; as in the JAX server there is no command-line flag for it).
The continuous-batching scheduler is not ported yet.

Example:
    python -m phi_3_vision_mlx_tpu_torch.serve.server --port 8000
    curl -X POST http://localhost:8000/v1/completions \\
      -H "Content-Type: application/json" \\
      -d '{"prompt": "Hello", "max_tokens": 64}'
"""

from __future__ import annotations

import json
from http.server import BaseHTTPRequestHandler, HTTPServer

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
                responses = generate(
                    body.get("prompt", ""),
                    preload=preload,
                    max_tokens=int(body.get("max_tokens", 128)),
                    verbose=False,
                    stream=False,
                    mute=True,
                    sample=float(body.get("temperature", 0.0)) > 0,
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


def serve(host: str = "127.0.0.1", port: int = 8000, preload=None, **load_kwargs):
    from ..api import load

    preload = preload or load(**load_kwargs)
    httpd = HTTPServer((host, port), make_handler(preload))
    print(f"Serving on http://{host}:{port}/v1/completions")
    httpd.serve_forever()


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    a = ap.parse_args()
    serve(a.host, a.port)
