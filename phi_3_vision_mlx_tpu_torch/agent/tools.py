"""Toolchain tools: code feedback, context loading, retrieval, API routing
(counterpart of ``phi_3_vision_mlx_tpu/agent/tools.py``; ``execute`` is in
``api.py``).

``rag`` reads its dataset with the ``datasets`` package unless
``HF_HUB_OFFLINE`` is set; offline, or when that fails, it retrieves from
the built-in snippets (``models/gte.py:VDB``), as the JAX one does.
"""

from __future__ import annotations

from typing import List

from ..models.gte import VDB, hub_offline


def add_code(prompt, codes):
    """Append the previous step's code blocks to the prompt (the feedback
    loop): one prompt a code, or the prompt as it is when ``codes`` is None."""
    if codes is None:
        return prompt
    return [f"{prompt}\n\n```python\n{code}\n```\n" for code in codes]


def add_text(prompt):
    """``question @ url-or-file`` -> the fetched text as context, then the
    question as the user turn."""
    from ..utils.media import fetch_text

    was_str = isinstance(prompt, str)
    prompts = [prompt] if was_str else prompt
    pairs = [p.split("@") for p in prompts]
    result = [f"{fetch_text(context.strip())}\n<|end|>\n<|user|>\n{question.strip()}"
              for question, context in pairs]
    return result[0] if was_str else result


def rag(prompt, repo_id: str = "JosefAlbers/sharegpt_python_mlx", n_topk: int = 1):
    """Prepend the top-k retrieved contexts of a vector store over a
    dataset (offline: over the built-in snippets)."""
    was_str = isinstance(prompt, str)
    prompts = [prompt] if was_str else prompt
    try:
        if hub_offline():
            raise RuntimeError("HF_HUB_OFFLINE is set")
        import datasets

        vdb = VDB(datasets.load_dataset(repo_id, split="train"))
    except Exception:
        vdb = VDB()
    context = vdb(prompts, n_topk)
    result = ["\n<|end|>\n".join(context[i][:n_topk]) + f"\n<|end|>\n<|user|>\n{prompts[i]}"
              for i in range(len(prompts))]
    return result[0] if was_str else result


def get_api(prompt, n_topk: int = 1, verbose: bool = True) -> List[str]:
    """Route each prompt by similarity to a built-in API snippet and format
    it with the text after ``<|api_input|>``."""
    prompts = [prompt] if isinstance(prompt, str) else prompt
    vdb = VDB()
    codes = vdb([p.split("<|api_input|>")[0] for p in prompts])
    codes = [code.format(prompt=prompts[i].split("<|api_input|>")[1].strip())
             for i, sublist in enumerate(codes) for code in sublist]
    if verbose:
        print("*** Obtained API Codes ***")
        for code in codes:
            print(code)
    return codes
