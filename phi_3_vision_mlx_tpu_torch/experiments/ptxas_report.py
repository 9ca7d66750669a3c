"""Registers, stack frame, spills and static shared memory of every kernel
the port builds, as ``nvcc -Xptxas -v`` reports them, for one or more
source trees of this repository.

    python -m phi_3_vision_mlx_tpu_torch.experiments.ptxas_report [--sources a.cu,b.cu] [TREE ...]

Each tree's ``phi_3_vision_mlx_tpu_torch/csrc/*.cu`` (or the named sources)
is compiled with the build's own flags (``ops/kernels/_build.NVCC_FLAGS``)
plus ``-Xptxas -v``, one ``nvcc`` per source, all started together, into a
temporary directory.  Prints one line per kernel instantiation: tree,
source, the kernel's demangled template arguments, registers, stack frame,
spill stores and loads, static shared memory.  Needs the CUDA toolkit; the
machine with the card has it.
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys
import tempfile

from ..ops.kernels._build import NVCC_FLAGS, _nvcc

_ENTRY = re.compile(r"Compiling entry function '(\S+)' for")
_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads")
_USED = re.compile(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?")


def demangle(names: list[str]) -> list[str]:
    """Kernel names as ``c++filt`` gives them, anonymous namespaces dropped."""
    try:
        out = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True, text=True,
                             timeout=60).stdout.splitlines()
    except OSError:
        return names
    return [re.sub(r"\(anonymous namespace\)::", "", n).split("(")[0] for n in out]


def parse(text: str) -> list[dict]:
    """-Xptxas -v output -> [{kernel, registers, stack, spill_stores, spill_loads, smem}]."""
    rows, cur = [], None
    for line in text.splitlines():
        if m := _ENTRY.search(line):
            cur = {"kernel": m.group(1)}
            rows.append(cur)
        elif cur is not None and (m := _FRAME.search(line)):
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)), spill_loads=int(m.group(3)))
        elif cur is not None and (m := _USED.search(line)):
            cur.update(registers=int(m.group(1)), smem=int(m.group(2) or 0))
    for row, name in zip(rows, demangle([r["kernel"] for r in rows])):
        row["kernel"] = name
    return rows


def report(tree: str, sources: list[str] | None = None) -> list[dict]:
    csrc = os.path.join(tree, "phi_3_vision_mlx_tpu_torch", "csrc")
    names = sources or sorted(f for f in os.listdir(csrc) if f.endswith(".cu"))
    with tempfile.TemporaryDirectory() as tmp:
        procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-c", os.path.join(csrc, n),
                                   "-o", os.path.join(tmp, n + ".o")],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for n in names]
        rows = []
        for name, proc in zip(names, procs):
            out, _ = proc.communicate()
            if proc.returncode != 0:
                raise SystemExit(f"{tree}/{name}: nvcc failed ({proc.returncode}):\n{out[-3000:]}")
            rows += [{"tree": tree, "source": name, **r} for r in parse(out)]
    return rows


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sources", help="comma-separated .cu files of csrc/ (default: all)")
    ap.add_argument("trees", nargs="*", default=["."])
    a = ap.parse_args(argv)
    rows = []
    for tree in a.trees:
        rows += report(tree, a.sources.split(",") if a.sources else None)
    for r in rows:
        print(f"{r['tree']} {r['source']} {r['kernel']}: {r.get('registers')} registers, "
              f"{r.get('stack')} B stack, {r.get('spill_stores')}/{r.get('spill_loads')} B spill "
              f"stores/loads, {r.get('smem')} B static smem", flush=True)
    return rows


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
