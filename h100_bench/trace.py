"""The traced stretch of a run: ``torch.profiler`` over a few seconds right
after the window closes, under the same load (its start and stop stall
the host for seconds, which inside the window would cut the tokens and
steps that the host-clock metrics count), reduced in memory to plain
records, and the arithmetic the per-layer readers share.

The served path launches from two threads of the scheduler (admission and
pump), both started before the profiler, so the profiler follows every
thread (``profile_all_threads``).  The benchmark's own ranges
(``record_function`` around the engine calls it wraps) and the CUDA
runtime calls each carry their thread's system id; a device operation
belongs to a range when the runtime call that launched it (the same
correlation id) ran on the range's thread inside it.  A graph replay's
kernels carry the replay's correlation id.  The window lies between two
marks the profiler records at its start and its stop, on the trace's own
clock; busy time and idle gaps count only what ran between them (work
queued before the start, or drained by the synchronization at the stop,
would otherwise make the device busier than the window is long).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

import torch


@dataclass
class Trace:
    """``ops``: device operations (name, start_ns, end_ns, correlation);
    ``ranges``: the benchmark's ranges (name, start_ns, end_ns, thread);
    ``launches``: runtime calls (name, start_ns, thread, correlation);
    ``start_ns``, ``end_ns``: the window's marks; ``window_s``: its
    length."""

    ops: list = field(default_factory=list)
    ranges: list = field(default_factory=list)
    launches: list = field(default_factory=list)
    start_ns: int = 0
    end_ns: int = 0

    @property
    def window_s(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def spans(self) -> list:
        """The union of the ops' intervals, cut to the window."""
        return [[max(s, self.start_ns), min(e, self.end_ns)] for s, e in merged(self.ops)
                if e > self.start_ns and s < self.end_ns]

    def ops_in(self, range_name: str) -> dict:
        """{range index: [device ops]} of each range named ``range_name``."""
        by_corr = {}
        for op in self.ops:
            by_corr.setdefault(op[3], []).append(op)
        out = {}
        for idx, (name, s, e, tid) in enumerate(self.ranges):
            if name != range_name:
                continue
            corr = [c for (_, t0, t, c) in self.launches if t == tid and s <= t0 <= e]
            out[idx] = [op for c in corr for op in by_corr.get(c, ())]
        return out

    def launches_in(self, range_name: str, prefix: str) -> int:
        """Runtime calls named ``prefix``... inside the ranges named
        ``range_name``, on their threads."""
        spans = [(s, e, tid) for (name, s, e, tid) in self.ranges if name == range_name]
        return sum(1 for (n, t0, t, _) in self.launches if n.startswith(prefix)
                   and any(tid == t and s <= t0 <= e for s, e, tid in spans))

    def busy_s(self) -> float:
        """Seconds of the window in which some device operation ran."""
        return sum(e - s for s, e in self.spans()) / 1e9

    def breakdown(self) -> dict:
        """The ten device operations that took most of the window, and the
        idle gaps summed by what the host was doing (the benchmark's ranges
        open at the gap's middle)."""
        by_op = {}
        for name, s, e, _ in self.ops:
            key = short_name(name)
            by_op[key] = by_op.get(key, 0.0) + max(0, min(e, self.end_ns) - max(s, self.start_ns)) / 1e9
        gaps = {}
        spans = [[self.start_ns] * 2] + self.spans() + [[self.end_ns] * 2]
        for (_, e0), (s1, _) in zip(spans, spans[1:]):
            if s1 <= e0:
                continue
            mid = (e0 + s1) / 2
            open_ = sorted({n for (n, s, e, _) in self.ranges if s <= mid <= e}) or ["no range"]
            key = "+".join(open_)
            gaps[key] = gaps.get(key, 0.0) + (s1 - e0) / 1e9
        top = lambda d: sorted(([k, v] for k, v in d.items()), key=lambda kv: -kv[1])[:10]  # noqa: E731
        return {"device_ops": top(by_op), "idle_gaps": top(gaps)}


def merged(ops) -> list:
    """The union of the ops' [start, end) intervals, in order."""
    out = []
    for s, e in sorted((op[1], op[2]) for op in ops):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def short_name(kernel: str) -> str:
    """A kernel's identifier without its return type, namespaces, template
    arguments and parameters."""
    name = re.sub(r"^void\s+", "", kernel.replace("(anonymous namespace)", "anon"))
    name = re.split(r"[<(]", name, maxsplit=1)[0].strip()
    return name.split("::")[-1][:60] or kernel[:60]


def device_ms(ops) -> float:
    return sum(e - s for _, s, e, _ in ops) / 1e6


EDGES = ("bench.window_open", "bench.window_close")


def mark(name: str) -> None:
    with torch.profiler.record_function(name):
        pass


class Profiler:
    """Starts and stops ``torch.profiler`` over every thread with CUDA
    activity, and reduces what it recorded to a :class:`Trace`; ``keep``
    names the benchmark's ranges."""

    def __init__(self, keep, cuda: bool = True):
        self.keep, self.cuda = set(keep), cuda

    def start(self) -> None:
        from torch._C._profiler import _ExperimentalConfig
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])
        self.prof = profile(activities=acts,
                            experimental_config=_ExperimentalConfig(profile_all_threads=True))
        self.prof.start()
        mark(EDGES[0])

    def stop(self) -> None:
        """Stop recording (cheap: the events are read by :meth:`reduce`,
        once the window has closed, so that their reading takes no host
        time from the window)."""
        mark(EDGES[1])
        if self.cuda:
            torch.cuda.synchronize()
        self.prof.stop()

    def reduce(self) -> Trace:
        tr, edges = Trace(), {}
        for ev in self.prof.profiler.kineto_results.events():
            name, start = ev.name(), ev.start_ns()
            if "CUDA" in str(ev.device_type()):
                if name not in self.keep and name not in EDGES:  # not the ranges' own
                    tr.ops.append((name, start, start + ev.duration_ns(), ev.correlation_id()))
            elif name in EDGES:
                edges[name] = start
            elif name in self.keep:
                tr.ranges.append((name, start, start + ev.duration_ns(), ev.device_resource_id()))
            elif name.startswith("cu") and ev.correlation_id():
                tr.launches.append((name, start, ev.device_resource_id(), ev.correlation_id()))
        del self.prof
        tr.start_ns, tr.end_ns = edges[EDGES[0]], edges[EDGES[1]]
        return tr
