"""GTE-large (BERT) sentence embedder and the in-memory vector store for
retrieval (counterpart of ``phi_3_vision_mlx_tpu/models/gte.py``; the
reference's ``gte.py``).

The encoder is a plain function over a parameter tree whose 24 layers are
stacked along axis 0 (the JAX package's layout): post-LN BERT blocks,
erf-GELU, float32 throughout.  The JAX package has no Pallas kernel here,
and neither does the port: attention and the linears are ``torch.matmul``.
It runs on the device its parameters are on: ``GteModel`` loads onto
``device="cuda"`` unless the caller names another.

The embedder is pluggable.  :class:`GteModel` loads the converted weights
(``model.npz`` in the flat MLX naming of ``vegaluisjose/mlx-rag``,
:func:`load_gte_npz`); it downloads them only where the JAX one does (no
directory at ``model_path``) and never with ``HF_HUB_OFFLINE`` set.  When
the weights or the tokenizer are unavailable, :func:`default_embedder`
falls back to :class:`HashEmbedder`, a deterministic lexical hashing
embedder, and says so on stderr.
"""

from __future__ import annotations

import dataclasses
import os
import sys
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

PATH_GTE = "models/gte"


@dataclasses.dataclass(frozen=True)
class GteConfig:
    dim: int = 1024
    num_attention_heads: int = 16
    num_hidden_layers: int = 24
    vocab_size: int = 30522
    layer_norm_eps: float = 1e-12
    max_position_embeddings: int = 512

    @property
    def head_dim(self) -> int:
        return self.dim // self.num_attention_heads

    @property
    def mlp_dim(self) -> int:
        return self.dim * 4


# -- the encoder (post-LN, erf-GELU) -------------------------------------------


def init_gte_params(cfg: GteConfig, generator: torch.Generator) -> dict:
    """Random float32 parameters in the stacked layout, drawn on
    ``generator``'s device: the JAX ``init_gte_params`` law (normal, scale
    ``fan_in ** -0.5`` for the linears, 0.02 for the embeddings; unit norms,
    zero biases), other numbers than ``jax.random``."""
    d, f, nl = cfg.dim, cfg.mlp_dim, cfg.num_hidden_layers
    dev = generator.device

    def normal(shape, scale):
        return torch.randn(shape, generator=generator, device=dev) * scale

    def linear(i, o):
        return {"weight": normal((nl, i, o), i**-0.5), "bias": torch.zeros((nl, o), device=dev)}

    def ln(*lead):
        return {"weight": torch.ones((*lead, d), device=dev), "bias": torch.zeros((*lead, d), device=dev)}

    return {
        "embeddings": {
            "word": normal((cfg.vocab_size, d), 0.02),
            "position": normal((cfg.max_position_embeddings, d), 0.02),
            "token_type": normal((2, d), 0.02),
            "norm": ln(),
        },
        "layers": {
            "q": linear(d, d),
            "k": linear(d, d),
            "v": linear(d, d),
            "o": linear(d, d),
            "ln1": ln(nl),
            "ln2": ln(nl),
            "ff1": linear(d, f),
            "ff2": linear(f, d),
        },
        "pooler": {"weight": normal((d, d), d**-0.5), "bias": torch.zeros((d,), device=dev)},
    }


def _ln(x, w, b, eps: float):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * w + b


def _dense(x, p: dict, i: int):
    return x @ p["weight"][i] + p["bias"][i]


@torch.no_grad()
def gte_forward(params: dict, cfg: GteConfig, input_ids, token_type_ids, attention_mask):
    """(B, L) ids, token types and mask -> (B, L, D) last hidden state,
    float32; padded keys take a score of ``-inf``."""
    emb = params["embeddings"]
    ids = torch.as_tensor(input_ids, device=emb["word"].device).long()
    types = torch.as_tensor(token_type_ids, device=ids.device).long()
    mask = torch.as_tensor(attention_mask, device=ids.device).bool()
    b, l = ids.shape
    x = (emb["word"][ids] + emb["position"][:l][None] + emb["token_type"][types]).float()
    x = _ln(x, emb["norm"]["weight"], emb["norm"]["bias"], cfg.layer_norm_eps)
    bias = torch.zeros(mask.shape, device=ids.device).masked_fill(~mask, float("-inf"))[:, None, None, :]
    h, dh = cfg.num_attention_heads, cfg.head_dim
    lay = params["layers"]
    eps = cfg.layer_norm_eps

    def heads(t):
        return t.reshape(b, l, h, dh).transpose(1, 2)

    for i in range(cfg.num_hidden_layers):
        q, k, v = (heads(_dense(x, lay[n], i)) for n in ("q", "k", "v"))
        scores = (q * dh**-0.5) @ k.transpose(-1, -2) + bias
        attn = (torch.softmax(scores, dim=-1) @ v).transpose(1, 2).reshape(b, l, h * dh)
        x = _ln(x + _dense(attn, lay["o"], i), lay["ln1"]["weight"][i], lay["ln1"]["bias"][i], eps)
        ff = _dense(F.gelu(_dense(x, lay["ff1"], i)), lay["ff2"], i)
        x = _ln(ff + x, lay["ln2"]["weight"][i], lay["ln2"]["bias"][i], eps)
    return x


def average_pool(last_hidden, attention_mask):
    """Mean of the hidden states over the mask's positions: (B, D)."""
    m = torch.as_tensor(attention_mask, device=last_hidden.device).float()[..., None]
    return (last_hidden * m).sum(dim=1) / m.sum(dim=1)


# -- npz weights (mlx-rag's flat MLX naming <-> the stacked tree) ---------------

_MLX_LAYER_KEYS = {
    "q": "attention.query_proj",
    "k": "attention.key_proj",
    "v": "attention.value_proj",
    "o": "attention.out_proj",
    "ln1": "ln1",
    "ln2": "ln2",
    "ff1": "linear1",
    "ff2": "linear2",
}


def load_gte_npz(npz_path: str, cfg: GteConfig, device="cpu") -> dict:
    """``model.npz`` (flat MLX module names, linear weights ``(out, in)``)
    -> the stacked float32 tree on ``device``.  A missing key raises, so a
    bad checkpoint cannot half-load."""
    from ..core.convert import from_numpy_gte_params

    raw = dict(np.load(npz_path))

    def get(name):
        if name not in raw:
            raise KeyError(f"GTE npz missing key: {name}")
        return raw[name]

    def stacked(name, transpose):
        out = np.stack([get(f"encoder.layers.{i}.{name}") for i in range(cfg.num_hidden_layers)])
        return np.swapaxes(out, -1, -2) if transpose else out

    layers = {
        ours: {"weight": stacked(f"{theirs}.weight", transpose=ours not in ("ln1", "ln2")),
               "bias": stacked(f"{theirs}.bias", transpose=False)}
        for ours, theirs in _MLX_LAYER_KEYS.items()
    }
    tree = {
        "embeddings": {
            "word": get("embeddings.word_embeddings.weight"),
            "position": get("embeddings.position_embeddings.weight"),
            "token_type": get("embeddings.token_type_embeddings.weight"),
            "norm": {"weight": get("embeddings.norm.weight"), "bias": get("embeddings.norm.bias")},
        },
        "layers": layers,
        "pooler": {"weight": get("pooler.weight").T, "bias": get("pooler.bias")},
    }
    return from_numpy_gte_params(tree, device=device)


def save_gte_npz(params: dict, cfg: GteConfig, npz_path: str) -> None:
    """Inverse of :func:`load_gte_npz`."""
    def a(t):
        return t.detach().float().cpu().numpy()

    flat = {
        "embeddings.word_embeddings.weight": a(params["embeddings"]["word"]),
        "embeddings.position_embeddings.weight": a(params["embeddings"]["position"]),
        "embeddings.token_type_embeddings.weight": a(params["embeddings"]["token_type"]),
        "embeddings.norm.weight": a(params["embeddings"]["norm"]["weight"]),
        "embeddings.norm.bias": a(params["embeddings"]["norm"]["bias"]),
        "pooler.weight": a(params["pooler"]["weight"]).T,
        "pooler.bias": a(params["pooler"]["bias"]),
    }
    for ours, theirs in _MLX_LAYER_KEYS.items():
        w, b = a(params["layers"][ours]["weight"]), a(params["layers"][ours]["bias"])
        for i in range(cfg.num_hidden_layers):
            flat[f"encoder.layers.{i}.{theirs}.weight"] = w[i].T if ours not in ("ln1", "ln2") else w[i]
            flat[f"encoder.layers.{i}.{theirs}.bias"] = b[i]
    np.savez(npz_path, **flat)


# -- embedders ------------------------------------------------------------------


def hub_offline() -> bool:
    """``HF_HUB_OFFLINE`` is set: nothing may be fetched."""
    return os.environ.get("HF_HUB_OFFLINE", "") not in ("", "0")


class GteModel:
    """GTE-large embedder (reference ``GteModel``): texts -> L2-normalized
    mean-pooled embeddings (N, D) float32, computed on ``device``."""

    name = "gte-large"

    def __init__(self, model_path: str = PATH_GTE, cfg: Optional[GteConfig] = None,
                 tokenizer=None, device="cuda"):
        import json

        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device; pass device='cpu' to embed on the CPU")
        if not os.path.exists(model_path):
            if hub_offline():
                raise RuntimeError(f"no GTE weights at {model_path} and HF_HUB_OFFLINE is set")
            from huggingface_hub import snapshot_download

            snapshot_download(repo_id="vegaluisjose/mlx-rag", local_dir=model_path)
            snapshot_download(repo_id="thenlper/gte-large", allow_patterns=["vocab.txt", "*.json"],
                              local_dir=model_path)
        if cfg is None:
            fields = {f.name for f in dataclasses.fields(GteConfig)}
            with open(os.path.join(model_path, "config.json")) as f:
                cfg = GteConfig(**{k: v for k, v in json.load(f).items() if k in fields})
        self.cfg = cfg
        self.params = load_gte_npz(os.path.join(model_path, "model.npz"), cfg, self.device)
        if tokenizer is None:
            from transformers import BertTokenizer

            tokenizer = BertTokenizer.from_pretrained(model_path)
        self.tokenizer = tokenizer

    def __call__(self, texts: List[str]) -> np.ndarray:
        toks = self.tokenizer(list(texts), return_tensors="np", padding=True, truncation=True,
                              max_length=self.cfg.max_position_embeddings)
        ids = toks["input_ids"].astype(np.int32)
        b, l = ids.shape
        l_pad = max(32, -(-l // 32) * 32)
        pad = ((0, 0), (0, l_pad - l))
        ids = np.pad(ids, pad)
        types = np.pad(toks.get("token_type_ids", np.zeros_like(ids[:, :l])), pad)
        mask = np.pad(toks["attention_mask"].astype(np.int32), pad)
        emb = average_pool(gte_forward(self.params, self.cfg, ids, types, mask), mask)
        return (emb / torch.linalg.norm(emb, dim=1, keepdim=True)).cpu().numpy()


class HashEmbedder:
    """Deterministic lexical hashing embedder (the offline fallback):
    bag-of-words hashed (md5) into a fixed-dim vector, L2-normalized, so
    cosine similarity scores lexical overlap, enough to route queries to the
    built-in API snippets with no network or weights."""

    name = "lexical-hash"

    def __init__(self, dim: int = 512):
        self.dim = dim

    def _tokens(self, text: str):
        import re

        return re.findall(r"[a-z0-9]+", text.lower())

    def __call__(self, texts: List[str]) -> np.ndarray:
        import hashlib

        out = np.zeros((len(texts), self.dim), np.float32)
        for i, t in enumerate(texts):
            for tok in self._tokens(t):
                h = int.from_bytes(hashlib.md5(tok.encode()).digest()[:4], "little")
                out[i, h % self.dim] += 1.0
        norms = np.linalg.norm(out, axis=1, keepdims=True)
        return out / np.maximum(norms, 1e-9)


def default_embedder(model_path: str = PATH_GTE):
    """:class:`GteModel` (on the card) if its weights load, else
    :class:`HashEmbedder`; either way it says on stderr which one is
    active."""
    try:
        model = GteModel(model_path)
        print("[gte] embedder: gte-large (real weights)", file=sys.stderr)
        return model
    except Exception as e:
        print(f"[gte] embedder: lexical-hash fallback (GTE unavailable: {type(e).__name__}: {e})",
              file=sys.stderr)
        return HashEmbedder()


# -- built-in API snippets (the reference's; the strings are the contract:
# get_api formats them with the <|api_input|> payload) ------------------------

_list_api = [
    """Text to image
```python
from gradio_client import Client
client = Client("stabilityai/stable-diffusion-3-medium")
result = client.predict(
		prompt="{prompt}",
		negative_prompt="ugly, low quality",
		seed=0,
		randomize_seed=True,
		width=1024,
		height=1024,
		guidance_scale=5,
		num_inference_steps=28,
		api_name="/infer"
)
print('<|api_output|>'+result[0])
```
""",
    """Text to speech
```python
from gradio_client import Client
client = Client("parler-tts/parler_tts_mini")
result = client.predict(
        text="{prompt}",
        description="",
        api_name="/gen_tts"
)
print('<|api_output|>'+result)
```
""",
    """Transcribe youtube video
```python
from gradio_client import Client
client = Client("rajesh1729/youtube-video-transcription-with-whisper")
result = client.predict(
        url="{prompt}",
        api_name="/get_summary"
)
print('<|api_output|>'+result)
```
""",
]


class VDB:
    """In-memory vector store (reference ``VDB``).

    * ``VDB()``: the built-in API snippets, keyed by their title line;
    * ``VDB(ds)``: a dataset with ``phi`` (text) and ``gte`` (precomputed
      embedding) columns;
    * ``embed=``: the embedder (default :func:`default_embedder`).
    """

    def __init__(self, ds=None, embed=None, n_line: int = 1):
        self.embed = embed if embed is not None else default_embedder()
        if ds is None:
            self.items = list(_list_api)
            keys = self.items if n_line < 0 else ["\n".join(s.split("\n")[:n_line]) for s in self.items]
            self.item_embeds = np.concatenate([np.asarray(self.embed([k])) for k in keys])
        else:
            self.items = list(ds["phi"])
            self.item_embeds = np.squeeze(np.asarray(ds.with_format(type="numpy", columns=["gte"])["gte"]))

    def __call__(self, texts, n_topk: int = 1):
        q = np.asarray(self.embed(list(texts)), np.float32)
        scores = q @ np.asarray(self.item_embeds, np.float32).T
        order = np.argsort(-scores, axis=1)[:, :n_topk]
        return [[self.items[j] for j in row] for row in order]
