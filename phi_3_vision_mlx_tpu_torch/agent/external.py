"""External inference-API tools (counterpart of
``phi_3_vision_mlx_tpu/agent/external.py``; the reference's ``api.py``).

``mistral_api`` chats with a hosted model, ``bark_api`` writes speech to
``bark.flac``.  Both need the network: with ``HF_HUB_OFFLINE`` set, or when
the call fails, they raise ``RuntimeError``.
"""

from __future__ import annotations

from ..models.gte import hub_offline

_history = []


def _client(model: str):
    if hub_offline():
        raise RuntimeError("HF_HUB_OFFLINE is set")
    from huggingface_hub import InferenceClient

    return InferenceClient(model)


def mistral_api(prompt: str, history=None, verbose: bool = True):
    """Hosted-model chat with a manual ``[INST]`` history."""
    global _history
    history = _history if history is None else history
    try:
        client = _client("mistralai/Mistral-7B-Instruct-v0.3")
        text = "<s>"
        for user, assistant in history:
            text += f"[INST] {user} [/INST]{assistant}</s>"
        text += f"[INST] {prompt} [/INST]"
        result = client.text_generation(text, max_new_tokens=1024, stream=False, details=False).strip()
    except Exception as e:
        raise RuntimeError(f"mistral_api requires network access to huggingface.co ({e})") from e
    history.append((prompt, result))
    _history = history
    if verbose:
        print(f"< mistral_api >\n{result}")
    return {"responses": result, "history": history}


def bark_api(prompt: str, verbose: bool = True):
    """Text to speech, written to ``bark.flac``."""
    try:
        audio = _client("suno/bark-small").text_to_speech(prompt)
        with open("bark.flac", "wb") as f:
            f.write(audio)
    except Exception as e:
        raise RuntimeError(f"bark_api requires network access to huggingface.co ({e})") from e
    if verbose:
        print("audio saved to bark.flac")
    return {"files": ["bark.flac"]}
