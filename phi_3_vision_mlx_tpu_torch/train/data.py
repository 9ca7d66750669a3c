"""Training and evaluation rows (counterpart of
``phi_3_vision_mlx_tpu/train/data.py``).

The reference trains and evaluates on the HF dataset
``JosefAlbers/akemiH_MedQA_Reason`` (columns ``input``, a question ending
in " A: ... E: ..." options; ``summary``, a one-line reasoning summary;
``output``, the correct letter).  Sources, as in the JAX package:

* ``"synthetic"``: deterministic generated rows of the same schema;
* a list of rows, or a local ``.json`` / ``.jsonl`` file;
* another local path: a ``datasets`` directory (``datasets`` is imported
  only then);
* a hub id, through ``datasets``, never with ``HF_HUB_OFFLINE`` set; when
  that fails, ``PHI3V_TPU_ALLOW_RANDOM=1`` gives the synthetic rows.
"""

from __future__ import annotations

import os
from typing import Dict, List

_TOPICS = [
    ("aspirin", "an antiplatelet agent", "inhibits cyclooxygenase"),
    ("metformin", "a biguanide", "decreases hepatic gluconeogenesis"),
    ("lisinopril", "an ACE inhibitor", "blocks angiotensin conversion"),
    ("atorvastatin", "a statin", "inhibits HMG-CoA reductase"),
    ("omeprazole", "a proton pump inhibitor", "blocks gastric acid secretion"),
    ("amoxicillin", "a beta-lactam antibiotic", "disrupts cell wall synthesis"),
    ("warfarin", "an anticoagulant", "antagonizes vitamin K"),
    ("insulin", "a peptide hormone", "promotes cellular glucose uptake"),
    ("albuterol", "a beta-2 agonist", "relaxes bronchial smooth muscle"),
    ("furosemide", "a loop diuretic", "inhibits the Na-K-2Cl cotransporter"),
]
_LETTERS = "ABCDE"


def synthetic_qa(n: int = 10) -> List[Dict[str, str]]:
    """Deterministic MedQA-shaped rows (schema parity with the reference's
    dataset columns)."""
    rows = []
    for i in range(n):
        name, klass, mech = _TOPICS[i % len(_TOPICS)]
        correct = _LETTERS[i % 5]
        options = " ".join(
            f"{letter}: option {letter.lower()}{i}" for letter in _LETTERS
        )
        q = (
            f"Q{i}: A patient is treated with {name}. Which statement about "
            f"this drug is correct? {options}"
        )
        rows.append(
            {
                "input": q,
                "summary": f"{name.capitalize()} is {klass} that {mech}.\nExtra detail line.",
                "output": correct,
            }
        )
    return rows


def load_qa_dataset(dataset_path: str, take=None) -> List[Dict[str, str]]:
    """Rows with 'input'/'summary'/'output' columns from any supported source."""
    rows: List[Dict[str, str]] = []
    n_wanted = take[1] if isinstance(take, tuple) else (take or 10)
    if dataset_path == "synthetic":
        rows = synthetic_qa(max(int(n_wanted), 10))
    elif isinstance(dataset_path, (list, tuple)):
        rows = list(dataset_path)
    elif os.path.exists(str(dataset_path)):
        import json

        p = str(dataset_path)
        if p.endswith(".jsonl"):
            with open(p) as f:
                rows = [json.loads(line) for line in f if line.strip()]
        elif p.endswith(".json"):
            with open(p) as f:
                rows = json.load(f)
        else:
            import datasets

            rows = list(datasets.load_from_disk(p))
    else:
        try:
            if os.environ.get("HF_HUB_OFFLINE", "") not in ("", "0"):
                raise ConnectionError("HF_HUB_OFFLINE is set: no download")
            import datasets

            rows = list(datasets.load_dataset(str(dataset_path), split="train"))
        except Exception as e:
            if os.environ.get("PHI3V_TPU_ALLOW_RANDOM", "") == "1":
                rows = synthetic_qa(max(int(n_wanted), 10))
            else:
                raise RuntimeError(
                    f"Could not load dataset {dataset_path!r} "
                    f"({type(e).__name__}: {e}).  Pass a local file, a list of "
                    "rows, 'synthetic', or set PHI3V_TPU_ALLOW_RANDOM=1."
                ) from e
    if take is not None:
        if isinstance(take, tuple):
            rows = rows[take[0] : take[1]]
        else:
            if take > len(rows):
                raise ValueError(
                    f"Requested {take} samples, but dataset only contains "
                    f"{len(rows)} samples."
                )
            rows = rows[:take]
    return rows
