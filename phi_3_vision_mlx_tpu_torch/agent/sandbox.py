"""Python code-execution sandbox of the agent toolchain (counterpart of
``phi_3_vision_mlx_tpu/agent/sandbox.py``; the reference's ``execute``).

Extracts the ```python``` blocks of a message, runs them in a subprocess of
the running interpreter (``sys.executable``), captures the output, and
harvests a plot file or an ``<|api_output|>``-announced artifact.  Failures
are captured (stderr returned, not raised), so a toolchain can feed the
error back into its next generation step.
"""

from __future__ import annotations

import re
import subprocess
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

_CODE_BLOCK = re.compile(r"```python\n(.*?)```", re.DOTALL)
_SAVEFIG = re.compile(r"plt\.savefig\(.*?\)")
API_OUTPUT_TAG = "<|api_output|>"


@dataclass
class RunResult:
    code: Optional[str] = None
    artifact: Optional[str] = None  # plot png or <|api_output|> file
    stdout: Optional[str] = None
    stderr: Optional[str] = None


def extract_code(text: str) -> str:
    """All ```python``` fenced blocks in ``text``, concatenated."""
    return "\n".join(_CODE_BLOCK.findall(text)).strip()


def _claim_artifact(raw_stdout: str, prefix) -> Optional[str]:
    """Move an ``<|api_output|>``-announced file under this run's prefix."""
    if API_OUTPUT_TAG not in raw_stdout:
        return None
    announced = raw_stdout.strip().split(API_OUTPUT_TAG, 1)[1]
    src = Path(announced)
    if not src.is_file():
        return announced
    dst = f"{prefix}_{src.name}"
    src.rename(dst)
    return dst


def run_code(text: str, prefix=0) -> RunResult:
    """Extract and run one message's code blocks in a python subprocess; a
    plot goes to ``{prefix}.png``."""
    code = extract_code(text)
    if not code:
        return RunResult()
    code = _SAVEFIG.sub("plt.show()", code)
    plot = f"{prefix}.png" if "plt.show()" in code else None
    program = code.replace("plt.show()", f"plt.savefig('{plot}')")
    proc = subprocess.run([sys.executable, "-c", program], capture_output=True, text=True)
    stdout = proc.stdout.strip()
    stderr = proc.stderr.strip()
    if stderr:
        return RunResult(code=code, stdout=stdout, stderr=stderr)
    return RunResult(code=code, artifact=plot if plot else _claim_artifact(proc.stdout, prefix),
                     stdout=stdout)


def execute(code_strings, file_prefix=0, verbose: bool = True) -> dict:
    """Run each message's code (one string or a list); returns the columns
    ``codes``, ``files``, ``souts`` and ``serrs``, one entry a message."""
    batch = [code_strings] if isinstance(code_strings, str) else list(code_strings)
    runs = [run_code(text, f"{file_prefix}_{i}") for i, text in enumerate(batch)]
    if verbose is True:
        print("*** Execution ***")
        for r in runs:
            for field in (r.code, r.artifact, r.stdout, r.stderr):
                print(field)
    return {
        "codes": [r.code for r in runs],
        "files": [r.artifact for r in runs],
        "souts": [r.stdout for r in runs],
        "serrs": [r.stderr for r in runs],
    }
