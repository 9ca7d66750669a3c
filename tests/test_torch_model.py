"""The port's text decoder and engine against the JAX package on the tiny
preset, 4-bit quantized, loaded by both from one checkpoint that the JAX
package wrote (``create_random_checkpoint`` + ``quantize_checkpoint``).

The checkpoint's scales and biases are first rounded to bf16-representable
values (the port stores them as bf16; the JAX CPU path keeps float32), so
both packages hold the same weights.  fp32 runs must agree to float32
rounding and give identical greedy tokens; bf16 runs compare logits within a
stated tolerance, since bf16 argmax near-ties may differ.
"""

import glob
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from phi_3_vision_mlx_tpu.api import _load as jax_load  # noqa: E402
from phi_3_vision_mlx_tpu.core import weights as JW  # noqa: E402
from phi_3_vision_mlx_tpu.core.config import KVQuantConfig  # noqa: E402
from phi_3_vision_mlx_tpu.engine import engine as JE  # noqa: E402
from phi_3_vision_mlx_tpu.models import phi3 as JM  # noqa: E402
from phi_3_vision_mlx_tpu_torch.api import _load as torch_load  # noqa: E402
from phi_3_vision_mlx_tpu_torch.core import weights as TW  # noqa: E402
from phi_3_vision_mlx_tpu_torch.core.convert import from_jax_kv_cache, from_numpy_params  # noqa: E402
from phi_3_vision_mlx_tpu_torch.engine import engine as TE  # noqa: E402
from phi_3_vision_mlx_tpu_torch.engine import state as TS  # noqa: E402
from phi_3_vision_mlx_tpu_torch.models import phi3 as TM  # noqa: E402
from phi_3_vision_mlx_tpu_torch.ops.rope import su_rope_tables  # noqa: E402

VOCAB = 32064  # full id space, so the ByteTokenizer's special ids are valid
PROMPT = "<|user|>\nTell me about lighthouses.<|end|>\n<|assistant|>\n"
# fp32 logits of O(1-10): both sides run the same f32 math, the sums in
# another order.
FP32_ATOL = 1e-4


def make_checkpoint(root, name, q_bits=4, **overrides):
    """JAX-written quantized (``q_bits``) tiny checkpoint with
    bf16-representable scales and biases (rewritten with the port's
    safetensors writer)."""
    raw, quant, out = (str(root / f"{name}{s}") for s in ("", "_q", "_qr"))
    JW.create_random_checkpoint(raw, "tiny", vocab_size=VOCAB, **overrides)
    JW.quantize_checkpoint(raw, quant, q_bits=q_bits)
    flat = TW.load_safetensors_dir(quant)
    for key, t in flat.items():
        if key.endswith((".scales", ".biases")):
            flat[key] = t.to(torch.bfloat16).float()
    os.makedirs(out)
    for f in glob.glob(f"{quant}/*.json"):
        shutil.copy(f, out)
    TW.save_safetensors(f"{out}/model.safetensors", flat)
    return out


@pytest.fixture(scope="module")
def fp32_path(tmp_path_factory):
    return make_checkpoint(tmp_path_factory.mktemp("ckpt"), "tiny")


@pytest.fixture(scope="module")
def fp32_pair(fp32_path):
    return jax_load(fp32_path), torch_load(fp32_path, device="cpu")


def _prefill_logits(pair, prompt, max_tokens):
    (jlm, jproc), (tlm, _) = pair
    dict_input = jproc(prompt)
    jl, *_ = JE.run_prefill(jlm, dict_input, max_tokens)
    tl, tstate, _, window = TE.run_prefill(tlm, dict_input, max_tokens)
    return np.asarray(jl), tl.numpy(), tstate, window


def _generate(pair, prompt, max_tokens):
    (jlm, jproc), (tlm, tproc) = pair
    kw = dict(max_tokens=max_tokens, verbose=False, stream=False, mute=True)
    return JE.generate_text(jlm, jproc, prompt, **kw), TE.generate_text(tlm, tproc, prompt, **kw)


def test_prefill_logits_fp32_match_jax(fp32_pair):
    jl, tl, _, _ = _prefill_logits(fp32_pair, PROMPT, 16)
    assert tl.shape == jl.shape == (1, VOCAB)
    np.testing.assert_allclose(tl, jl, rtol=0, atol=FP32_ATOL)


@pytest.mark.parametrize("prompt", [PROMPT, ["Hi", "A longer second prompt."]])
def test_greedy_tokens_identical_fp32(fp32_pair, prompt):
    """16 greedy tokens through ``generate_text`` (single and left-padded
    batch); ByteTokenizer renders unknown ids visibly, so equal text means
    equal token ids."""
    jout, tout = _generate(fp32_pair, prompt, 16)
    assert tout == jout
    assert all(len(t) > 0 for t in tout)


def test_long_window_switches_to_long_factors(fp32_pair):
    """A window above ``original_max_position_embeddings`` (128 on the tiny
    preset) selects the long su-factors; the port still matches JAX."""
    (_, _), (tlm, _) = fp32_pair
    cfg = tlm.cfg
    prompt = PROMPT.replace("lighthouses", "the keeper's log, the weather and the ships")
    jl, tl, state, window = _prefill_logits(fp32_pair, prompt, 64)
    assert window > cfg.original_max_position_embeddings
    long_cos, _ = su_rope_tables(cfg, window)
    short_cos, _ = su_rope_tables(cfg, cfg.original_max_position_embeddings)
    assert not torch.allclose(long_cos[:, :16], short_cos[:, :16])
    np.testing.assert_allclose(tl, jl, rtol=0, atol=FP32_ATOL)
    jout, tout = _generate(fp32_pair, prompt, 16)
    assert tout == jout


def test_chunked_prefill_matches_jax(fp32_pair, monkeypatch):
    """Prompts above PREFILL_CHUNK prefill in chunks through decode_forward."""
    monkeypatch.setattr(JE, "PREFILL_CHUNK", 64)
    monkeypatch.setattr(TE, "PREFILL_CHUNK", 64)
    prompt = PROMPT.replace("lighthouses", "lighthouses " * 12)
    jl, tl, state, _ = _prefill_logits(fp32_pair, prompt, 8)
    assert state.offset > 64
    np.testing.assert_allclose(tl, jl, rtol=0, atol=FP32_ATOL)


def test_decode_forward_advance_contract(fp32_pair):
    """``advance=0`` scores without committing; the cache is written in place."""
    (_, _), (tlm, tproc) = fp32_pair
    _, state, _, _ = TE.run_prefill(tlm, tproc(PROMPT), 8)
    k_before = state.k.clone()
    ids = torch.tensor([[1000 + 65]])
    res = TM.decode_forward(tlm.params, tlm.cfg, state, ids, advance=0)
    assert res.state.offset == state.offset and res.state.k is state.k
    assert not torch.equal(state.k[:, :, :, state.offset], k_before[:, :, :, state.offset])
    again = TM.decode_forward(tlm.params, tlm.cfg, res.state, ids)
    assert again.state.offset == state.offset + 1
    np.testing.assert_allclose(again.logits.numpy(), res.logits.numpy(), rtol=0, atol=1e-5)


def test_from_numpy_params_matches_checkpoint_path(fp32_pair):
    (jlm, _), (tlm, _) = fp32_pair
    tree = jax.tree_util.tree_map(np.asarray, jlm.params)
    converted = from_numpy_params(tree, jlm.cfg)

    def walk(a, b, path=""):
        if isinstance(a, dict):
            assert a.keys() == b.keys(), path
            for k in a:
                walk(a[k], b[k], f"{path}.{k}")
        else:
            assert a.dtype == b.dtype and torch.equal(a, b), path

    walk(converted, tlm.params)


def test_bf16_logits_close_to_jax(tmp_path_factory):
    """bf16 model: JAX multiplies bf16 x bf16 -> bf16 per matmul on the CPU,
    the port accumulates in f32 and rounds once, so activations differ at
    bf16 rounding (2**-8 relative) per op through 2 layers (about 1% relative
    L2 on the logits); they must agree to 3% and in their top token set."""
    path = make_checkpoint(tmp_path_factory.mktemp("ckpt16"), "tiny16", dtype="bfloat16")
    pair = (jax_load(path), torch_load(path, device="cpu"))
    jl, tl, _, _ = _prefill_logits(pair, PROMPT, 16)
    rel = np.linalg.norm(tl - jl) / np.linalg.norm(jl)
    assert rel < 3e-2, rel
    top_t = set(np.argsort(tl[0])[-5:])
    assert np.argmax(jl[0]) in top_t


def test_unquantized_checkpoint_matches_jax(tmp_path):
    """``_load`` reads an unquantized JAX checkpoint too (plain matmuls)."""
    path = str(tmp_path / "raw")
    JW.create_random_checkpoint(path, "tiny", vocab_size=VOCAB)
    pair = (jax_load(path), torch_load(path, device="cpu"))
    assert "weight" in pair[1][0].params["lm_head"]
    jl, tl, _, _ = _prefill_logits(pair, PROMPT, 8)
    np.testing.assert_allclose(tl, jl, rtol=0, atol=FP32_ATOL)


def test_load_without_checkpoint_names_the_synthetic_path(tmp_path, monkeypatch):
    """With no checkpoint and no ``PHI3V_TPU_ALLOW_RANDOM``, ``load`` raises
    ``RuntimeError`` as the JAX offline ``_setup`` does, and names the
    variable, the port's own checkpoint writers and the synthetic weights."""
    from phi_3_vision_mlx_tpu_torch import api

    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("PHI3V_TPU_ALLOW_RANDOM", raising=False)
    with pytest.raises(RuntimeError, match="PHI3V_TPU_ALLOW_RANDOM.*create_random_checkpoint"
                                           ".*quantize_checkpoint.*synth_quantized_params"):
        api.load()


def test_no_silent_cpu_fallback(fp32_path, fp32_pair, monkeypatch):
    """Models load onto CUDA unless the caller names a device; with no card
    that raises instead of carrying on on the CPU."""
    from phi_3_vision_mlx_tpu_torch import api

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    (_, _), (tlm, _) = fp32_pair
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api._load(fp32_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TE.LM(tlm.cfg, tlm.params, device="cuda")
    with pytest.raises(TypeError):
        TE.LM(tlm.cfg, tlm.params)  # the device is never implied
    assert TE.LM(tlm.cfg, tlm.params, device="cpu").device.type == "cpu"


# --- The quantized KV cache: both packages load one checkpoint with
# ``use_quantized_cache=True``; the 8-bit cases replace ``kv_quant`` (the
# checkpoint config has no field for it) and pin the routing by bits.
# D = 96 (three quantization groups, GQA 2:1) overrides the tiny preset.
#
# Rounding to 16 (or 256) levels is discontinuous: the two packages' f32
# activations differ by ~1e-7 (sums in another order), and a value that close
# to a level boundary rounds to the neighbouring level in one of them.  One
# such value among ~12K in layer 0 moved the tiny D = 96 model's logits by
# 0.1.  So the port's run writes the JAX package's quantized entries in place
# of its own (``ReplayJaxCache``), which holds everything downstream of the
# quantizer (layout, offsets, routing, attention, engine) to float32
# agreement, and it checks the port's own entries against the JAX ones:
# equal but for a few values one level apart.  The quantizer alone is held
# bit for bit in tests/test_torch_kv_quant.py.
D96 = dict(hidden_size=192, num_attention_heads=2, num_key_value_heads=1)
MAX_FLIP_SHARE = 1e-3  # of the values written


@pytest.fixture(scope="module")
def d96_path(tmp_path_factory):
    return make_checkpoint(tmp_path_factory.mktemp("ckpt96"), "tiny96", **D96)


@pytest.fixture(scope="module", params=[(32, 4), (96, 4), (32, 8), (96, 8)],
                ids=["int4-D32", "int4-D96", "int8-D32", "int8-D96"])
def qcache_pair(request, fp32_path, d96_path):
    d, bits = request.param
    path = fp32_path if d == 32 else d96_path
    (jlm, jproc), (tlm, tproc) = jax_load(path, use_quantized_cache=True), torch_load(
        path, device="cpu", use_quantized_cache=True)
    assert jlm.cfg.use_quantized_cache and tlm.cfg.use_quantized_cache and tlm.cfg.head_dim == d
    kvq = KVQuantConfig(bits=bits)
    jlm = JE.LM(jlm.cfg.replace(kv_quant=kvq), jlm.params, model_path=path)
    tlm = TE.LM(tlm.cfg.replace(kv_quant=kvq), tlm.params, model_path=path, device="cpu")
    return (jlm, jproc), (tlm, tproc)


class ReplayJaxCache:
    """``update_layer_chunk`` for the port that writes the entries of a JAX
    cache (every position the run writes must be in it) instead of its own
    quantization, and counts where its own entries differ."""

    def __init__(self, jax_state, bits: int):
        kv = jax_state.kv
        self.payload, self.scales = from_jax_kv_cache(
            np.asarray(kv.k), np.asarray(kv.k_scales.astype(jnp.float32)), bits)
        self.bits, self.values, self.flips, self.max_step = bits, 0, 0, 0

    def _levels(self, payload):
        return torch.stack([payload & 15, payload >> 4]) if self.bits == 4 else payload

    def __call__(self, state, layer, pos, k_new, v_new):
        want_p, want_s = self.payload[layer, :, :, pos], self.scales[layer, :, :, pos]
        own_p, own_s = TS.quantize_chunk(k_new, v_new, state.kv_quant)
        step = (self._levels(own_p).int() - self._levels(want_p).int()).abs()
        self.values += step.numel()
        self.flips += int((step > 0).sum())
        self.max_step = max(self.max_step, int(step.max()))
        torch.testing.assert_close(own_s.float(), want_s.float(), rtol=2.0**-7, atol=1e-6)
        state.k[layer, :, :, pos], state.k_scales[layer, :, :, pos] = want_p, want_s

    def check(self):
        assert self.values > 0 and self.max_step <= 1
        assert self.flips <= MAX_FLIP_SHARE * self.values, (self.flips, self.values)


def _jax_decode(jlm, dict_input, max_tokens):
    """JAX prefill, then greedy steps through ``decode_forward``: the
    prefill logits and the state holding every position the run wrote."""
    jl, state, _, _ = JE.run_prefill(jlm, dict_input, max_tokens)
    tok = np.asarray(jl).argmax(-1)[:, None]
    for _ in range(max_tokens - 1):
        res = JM.decode_forward(jlm.params, jlm.cfg, state, jnp.asarray(tok))
        state, tok = res.state, np.asarray(res.logits[:, -1]).argmax(-1)[:, None]
    return np.asarray(jl), state


def test_quantized_cache_prefill_logits_match_jax(qcache_pair, monkeypatch):
    (jlm, jproc), (tlm, _) = qcache_pair
    dict_input = jproc(PROMPT)
    jl, jstate, _, _ = JE.run_prefill(jlm, dict_input, 16)
    replay = ReplayJaxCache(jstate, tlm.cfg.kv_quant.bits)
    monkeypatch.setattr(TM, "update_layer_chunk", replay)
    tl, state, _, _ = TE.run_prefill(tlm, dict_input, 16)
    assert state.quantized and state.k.dtype == torch.uint8 and state.v is None
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=FP32_ATOL)
    replay.check()


@pytest.mark.parametrize("prompt", [PROMPT, ["Hi", "A longer second prompt."]], ids=["single", "batch"])
def test_quantized_cache_greedy_tokens_identical(qcache_pair, prompt, monkeypatch):
    """16 greedy tokens through the port's ``generate_text`` (single and
    left-padded batch) equal the JAX package's ``generate_text``."""
    (jlm, jproc), (tlm, tproc) = qcache_pair
    _, jstate = _jax_decode(jlm, jproc(prompt), 16)
    replay = ReplayJaxCache(jstate, tlm.cfg.kv_quant.bits)
    monkeypatch.setattr(TM, "update_layer_chunk", replay)
    jout, tout = _generate(qcache_pair, prompt, 16)
    assert tout == jout
    assert all(len(t) > 0 for t in tout)
    replay.check()


def test_quantized_cache_chunked_prefill_matches_jax(qcache_pair, monkeypatch):
    """Chunks of 64 extend the quantized cache through decode_forward (K5's
    path on the card; int8 through read_kv and K2)."""
    (jlm, jproc), (tlm, _) = qcache_pair
    monkeypatch.setattr(JE, "PREFILL_CHUNK", 64)
    monkeypatch.setattr(TE, "PREFILL_CHUNK", 64)
    dict_input = jproc(PROMPT.replace("lighthouses", "lighthouses " * 12))
    jl, jstate, _, _ = JE.run_prefill(jlm, dict_input, 8)
    replay = ReplayJaxCache(jstate, tlm.cfg.kv_quant.bits)
    monkeypatch.setattr(TM, "update_layer_chunk", replay)
    tl, state, _, _ = TE.run_prefill(tlm, dict_input, 8)
    assert state.offset > 64
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=FP32_ATOL)
    replay.check()


def test_load_quantize_cache_generates_the_jax_text(fp32_path, tmp_path, monkeypatch):
    """``api.load(quantize_cache=True)`` and ``_load(..., use_quantized_cache=
    True)`` set the flag and generate what the JAX package generates."""
    from phi_3_vision_mlx_tpu_torch import api

    jlm, jproc = jax_load(fp32_path, use_quantized_cache=True)
    want = JE.generate_text(jlm, jproc, PROMPT, max_tokens=12, verbose=False, stream=False, mute=True)
    monkeypatch.chdir(tmp_path)
    os.makedirs("models")
    for path in (api.PATH_ORIGINAL_PHI3_BLIND, api.PATH_QUANTIZED_PHI3_BLIND):
        os.symlink(fp32_path, path)
    for lm, proc in (api.load(blind_model=True, quantize_cache=True, device="cpu"),
                     api._load(fp32_path, device="cpu", use_quantized_cache=True)):
        assert lm.cfg.use_quantized_cache
        got = api.generate(PROMPT, preload=(lm, proc), max_tokens=12, verbose=False, stream=False,
                           mute=True, apply_chat_template=False)
        assert got == want
    assert not api.load(blind_model=True, device="cpu")[0].cfg.use_quantized_cache
    with pytest.raises(NotImplementedError, match="adapters"):
        api.load(quantize_cache=True, use_adapter=True, device="cpu")
