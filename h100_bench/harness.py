"""One run of one cell: set up the served system, load it for the window,
read the metrics, check the answers, and return the result line.

The system under test is ``phi_3_vision_mlx_tpu_torch``'s continuous
scheduler (``serve/server.py:ContinuousScheduler``, ``paged=True``, its own
chunk, admission batch and pipelining) over the paged engine: client
threads call ``complete``, the call behind the HTTP handler, as closed
loops.  The benchmark hands the program checkpoint-format weights it made
from the seed (converted by the program's own ``prepare_params``), the
prompt text and the raw pixels, and reads back the served tokens, the
engine's per-request token lists at the window's edges, and, in a traced
run, the device trace and its own ranges around the engine's calls.
"""

from __future__ import annotations

import gc
import math
import sys
import threading
import time

import numpy as np
import torch

from . import check, spec, traffic as traffic_mod, weights
from .reference import image, tokenizer
from .trace import Profiler

GRACE_S = 60.0  # how long past the window a due request may still finish
RANGES = ("prepare_many", "prepare", "step_pipelined")
FORBIDDEN = ("jax", "jaxlib", "flax", "phi_3_vision_mlx_tpu")


class Pixels:
    """A decoded RGB image as the program's processor takes one: ``.size``
    (width, height), ``.convert("RGB")`` and the array protocol."""

    def __init__(self, pixels: np.ndarray):
        self.pixels = pixels
        self.size = (pixels.shape[1], pixels.shape[0])

    def convert(self, mode):
        return self

    def __array__(self, dtype=None, copy=None):
        return self.pixels if dtype is None else self.pixels.astype(dtype)


class Run:
    """What a metric reader reads: the cell's configuration and traffic,
    the window, the requests due in it, the engine's token counts at its
    edges, and with ``--trace 1`` the trace and the range samples."""

    def __init__(self, parts: dict, seconds: float):
        self.cfg, self.traffic = parts["config"], parts["traffic"]
        self.seconds = seconds
        self.records, self.trace, self.occupancy, self.late = [], None, [], 0
        self.at_open = self.at_close = {}


def build(parts: dict, seed: int, device):
    """The program, set up as it serves: (scheduler, lm)."""
    from phi_3_vision_mlx_tpu_torch.core.config import config_from_dict
    from phi_3_vision_mlx_tpu_torch.core.weights import prepare_params
    from phi_3_vision_mlx_tpu_torch.engine.engine import LM
    from phi_3_vision_mlx_tpu_torch.models.image_processor import Phi3VImageProcessor
    from phi_3_vision_mlx_tpu_torch.models.preprocess import Phi3Processor, Phi3VProcessor
    from phi_3_vision_mlx_tpu_torch.models.tokenizer import ByteTokenizer
    from phi_3_vision_mlx_tpu_torch.serve.server import ContinuousScheduler

    raw = parts["config"]
    cfg = config_from_dict(raw)
    t0 = time.perf_counter()
    ckpt = weights.checkpoint(raw, seed, device)
    t1 = time.perf_counter()
    lm = LM(cfg, prepare_params(ckpt, cfg), device=device)
    del ckpt
    t2 = time.perf_counter()
    if cfg.has_vision:
        proc = Phi3VProcessor(tokenizer=ByteTokenizer())
        proc.img_processor = Phi3VImageProcessor(raw["num_crops"])
    else:
        proc = Phi3Processor(tokenizer=ByteTokenizer())
    srv = parts["traffic"]["server"]
    sched = ContinuousScheduler(lm, proc, slots=srv["slots"], window=srv["window"], paged=True,
                                page_size=srv["page_size"])
    print(f"set-up: weights made {t1 - t0:.2f} s, converted {t2 - t1:.2f} s, scheduler (kernel "
          f"library, pool, graph capture) {time.perf_counter() - t2:.2f} s", file=sys.stderr)
    return sched, lm


def snapshot(sched) -> dict:
    """{rid: (tokens so far, prompt tokens, image tokens)} under the
    scheduler's lock."""
    with sched._cv:
        return {rid: (len(r.tokens), len(r.prompt_ids),
                      sum(1 for t in r.prompt_ids if t < 0) if r.has_images else 0)
                for rid, r in sched.engine.requests.items()}


def wrap_ranges(sched, run: Run):
    """Name the engine's admission and decode calls for the profiler, and
    sample the busy slots at each dispatched chunk (traced runs only)."""
    eng = sched.engine

    def ranged(name, fn):
        def wrapper(*a, **kw):
            if name == "step_pipelined":  # the pump calls this under the scheduler's lock
                run.occupancy.append((time.perf_counter(), len(eng.by_slot)))
            with torch.profiler.record_function(name):
                return fn(*a, **kw)
        return wrapper

    for name in RANGES:
        setattr(eng, name, ranged(name, getattr(eng, name)))


class Clients:
    """The load: closed-loop clients, each sending its next request when
    the last returns, taken in order from the traffic's sequence."""

    def __init__(self, sched, traf: traffic_mod.Traffic, n: int):
        self.sched, self.traf = sched, traf
        self.lock, self.next = threading.Lock(), 0
        self.records, self.inflight = [], {}
        self.stop = threading.Event()
        self.threads = [threading.Thread(target=self.loop, daemon=True, name=f"bench.client{c}")
                        for c in range(n)]

    def start(self):
        for t in self.threads:
            t.start()

    def send(self, req: dict) -> None:
        images = None
        if req["image"] is not None:
            images = [Pixels(self.traf.pixels(req["index"], req["image"]))]
        rec = {"index": req["index"], "sent": time.perf_counter(), "done": None, "error": None}
        with self.lock:
            self.inflight[req["index"]] = rec
        try:
            self.sched.complete(req["prompt"], req["max_tokens"], images=images)
        except Exception as e:  # a failed request is counted, not fatal
            rec["error"] = f"{type(e).__name__}: {e}"
        rec["done"] = time.perf_counter()
        with self.lock:
            del self.inflight[req["index"]]
            self.records.append(rec)

    def loop(self):
        while not self.stop.is_set():
            with self.lock:
                i, self.next = self.next, self.next + 1
            self.send(self.traf.request(i))

    def oldest_inflight(self) -> float:
        with self.lock:
            return min((r["sent"] for r in self.inflight.values()), default=math.inf)

    def join(self, timeout: float) -> int:
        """Stop the load, wait up to ``timeout`` for its threads, and return
        how many still run."""
        self.stop.set()
        end = time.perf_counter() + timeout
        for t in self.threads:
            t.join(max(0.0, end - time.perf_counter()))
        return sum(t.is_alive() for t in self.threads)


def warm_up(sched, traf: traffic_mod.Traffic) -> None:
    """Serve the traffic's warm-up requests, all at once, so that every
    prefill bucket and image shape has run once before the window."""
    clients = Clients(sched, traf, 0)
    threads = [threading.Thread(target=clients.send, args=(r,)) for r in traf.warm_up()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    bad = [r["error"] for r in clients.records if r["error"]]
    if bad:
        raise RuntimeError(f"a warm-up request failed: {bad[0]}")


def run(cell: str, seed: int, seconds: float, trace: bool, t_process: float, device="cuda",
        parts: dict = None, chips: int = 1, control: bool = False) -> dict:
    """One run; returns the result line's dict.  With ``control`` (never in
    the benchmark's own runs) the control's gap on the same sample stands
    in the check in the program's place, so ``correct`` judges the control,
    and the program's own gap is kept under ``served``."""
    parts = parts or spec.load(cell)
    traf = traffic_mod.Traffic(parts["traffic"], seed)
    tp = parts["traffic"]
    cuda = torch.device(device).type == "cuda"
    sched, lm = build(parts, seed, device)
    t_warm = time.perf_counter()
    warm_up(sched, traf)
    print(f"set-up: warm-up {time.perf_counter() - t_warm:.2f} s", file=sys.stderr)
    r = Run(parts, seconds)
    clients = Clients(sched, traf, tp.get("clients", 0))
    if trace:
        wrap_ranges(sched, r)
    t_load = time.perf_counter()
    setup_s = t_load - t_process
    clients.start()
    time.sleep(tp["ramp_seconds"])
    t_open = time.perf_counter()
    r.at_open = snapshot(sched)
    time.sleep(seconds)
    t_close = time.perf_counter()
    r.at_close = snapshot(sched)
    if trace:  # right after the window, under the same load: starting and stopping
        prof = Profiler(RANGES, cuda)  # the profiler stalls the host for seconds
        prof.start()
        time.sleep(tp["trace_seconds"])
        prof.stop()
    while clients.oldest_inflight() < t_close and time.perf_counter() < t_close + GRACE_S:
        time.sleep(0.02)
    left = clients.join(GRACE_S)
    if trace:
        r.trace = prof.reduce()
    due = [x for x in clients.records if t_open <= x["sent"] < t_close]
    late = [x for x in list(clients.inflight.values()) if t_open <= x["sent"] < t_close]
    r.records, r.late = due, len(late)
    r.occupancy = [n for t, n in r.occupancy if t_open <= t < t_close]
    peak = torch.cuda.max_memory_allocated() if cuda else 0

    # The answers to judge, found by their prompt ids as the reference forms
    # them, then the program's state freed before the reference runs.
    eng = sched.engine
    ids = {tuple(q.prompt_ids): rid for rid, q in eng.requests.items()}
    done, unmatched = [], 0
    for x in due:
        if x["error"] is None:
            req = traf.request(x["index"])
            counts = [] if req["image"] is None else [
                image.tokens(*image.grid(*req["image"], parts["config"]["num_crops"])[0])]
            rid = ids.get(tuple(tokenizer.prompt_ids(req["prompt"], counts)))
            if rid is None:
                unmatched += 1
                continue
            q = eng.requests[rid]
            done.append({**req, "tokens": list(q.tokens), "max_tokens": q.max_tokens, "slot": q.slot})
    eos = lm.eos_id
    del sched, lm, eng, ids, clients
    gc.collect()
    for t in threading.enumerate():
        if t.name.startswith("ContinuousScheduler."):
            t.join(5.0)
    if cuda:
        torch.cuda.empty_cache()

    metrics = {}
    for m in parts["per_layer" if trace else "end_to_end"]:
        if m["name"] == "setup_s":
            value = setup_s
        else:
            value = spec.reader(m["name"], parts["root"])(r)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    picked = check.sample(done, seed)
    for it in picked:
        if it["image"] is not None:
            it["pixels"] = traf.pixels(it["index"], it["image"])
    ref_params = weights.checkpoint(parts["config"], seed, device)
    read = check.gaps(parts["config"], ref_params, picked, device, control) if picked else {}
    gap = read.get("control" if control else "served", math.inf)
    del ref_params
    slots = tp["server"]["slots"]
    failed = sum(1 for x in due if x["error"]) + len(late)
    checks = {
        "logit_gap": {"value": gap, "limit": parts["limits"]["logit_gap"]["limit"]},
        "short_answers": {"value": check.short_answers(done, eos), "limit": 0},
        "failed": {"value": failed, "limit": 0},
        "unmatched_prompts": {"value": unmatched, "limit": 0},
        "sampled_slots": {"value": len({it["slot"] for it in picked}), "limit": slots},
        "client_threads_left": {"value": left, "limit": 0},
    }
    correct = (left == 0 and gap <= checks["logit_gap"]["limit"]
               and checks["short_answers"]["value"] == 0 and failed == 0 and unmatched == 0
               and checks["sampled_slots"]["value"] >= slots)
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": chips, "memory_peak_bytes": peak}
    out = {"correct": bool(correct), "attempted": len(due) + len(late), "failed": failed,
           "metrics": metrics, "device": dev}
    if trace and r.trace is not None:
        dev["busy_s"], dev["window_s"] = r.trace.busy_s(), r.trace.window_s
        out["breakdown"] = r.trace.breakdown()
    if control:
        out["served"] = read.get("served")
    out["checks"] = checks
    return out


def forbidden_modules() -> list:
    """Modules loaded in this process whose top-level name is JAX's, Flax's
    or the JAX package's (the port's own name begins with the latter)."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})
