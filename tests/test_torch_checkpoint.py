"""Checkpoint I/O of the port against the JAX package: raw HuggingFace
directories (``load_params``, ``sanitize_checkpoint``, ``quantize_checkpoint``)
and the native zero-copy safetensors reader (``core/native.py``).

A raw directory is written as ``tests/test_conversion.py`` writes one (this
module keeps its own copies of its helpers): the JAX ``init_params`` tree of
a tiny preset as numpy float32, HF key names, linears ``(out, in)``, the
patch embedding NCHW, two shards, a config without ``layout``.  Both
packages cast float tensors to the config's dtype (bf16) with one rounding
to nearest even, and quantize with the same f32 arithmetic, so every
comparison here is exact.

The native reader needs g++ once, to build ``csrc/st_mmap.cpp``; its tests
skip, naming the tool, where g++ is absent.
"""

import json
import os
import shutil
import struct

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from phi_3_vision_mlx_tpu.core import weights as JW  # noqa: E402
from phi_3_vision_mlx_tpu.core.config import config_to_dict  # noqa: E402
from phi_3_vision_mlx_tpu.core.config import preset as jax_preset  # noqa: E402
from phi_3_vision_mlx_tpu.models import phi3 as JM  # noqa: E402
from phi_3_vision_mlx_tpu_torch.core import native  # noqa: E402
from phi_3_vision_mlx_tpu_torch.core import weights as TW  # noqa: E402
from test_torch_model import one_thread  # noqa: E402,F401  (autouse: one torch thread)

needs_gxx = pytest.mark.skipif(shutil.which("g++") is None,
                               reason="g++ not found: the native safetensors reader is not built")
PRESETS = ["tiny", "tiny_vision"]


def _to_hf_flat(params):
    """A JAX params tree -> the HF on-disk convention (flat, float32)."""
    out = {}
    for name, arr in JW.flatten_params(params).items():
        arr = np.asarray(arr, np.float32)
        if name.endswith(".weight") and JW._is_linear_weight(name) and arr.ndim == 2:
            arr = arr.T  # (in, out) -> HF (out, in)
        if "patch_embedding.weight" in name and arr.ndim == 4:
            arr = arr.transpose(0, 3, 1, 2)  # OHWI -> NCHW
        out[name] = np.ascontiguousarray(arr)
    return out


def _write_hf_checkpoint(path, cfg, hf_flat, shards=2):
    os.makedirs(path, exist_ok=True)
    d = config_to_dict(cfg)
    d.pop("layout", None)
    d.pop("sanitized", None)  # raw HF checkpoints carry neither marker
    with open(f"{path}/config.json", "w") as f:
        json.dump(d, f)
    with open(f"{path}/tokenizer_config.json", "w") as f:
        json.dump({"model_max_length": 131072}, f)
    keys = sorted(hf_flat)
    per = -(-len(keys) // shards)
    for i in range(shards):
        chunk = {k: hf_flat[k] for k in keys[i * per : (i + 1) * per]}
        if chunk:
            JW.save_safetensors(f"{path}/model-{i:05d}-of-{shards:05d}.safetensors", chunk)


def _raw_dir(name: str, tmp_path_factory):
    """(preset name, raw HF directory, the JAX params it was written from)."""
    cfg = jax_preset(name, dtype="bfloat16")  # the f32 files are cast as they load
    params = JM.init_params(cfg, jax.random.PRNGKey(0))
    path = str(tmp_path_factory.mktemp(f"hf_{name}") / "raw")
    _write_hf_checkpoint(path, cfg, _to_hf_flat(params))
    return name, path, params


@pytest.fixture(scope="module", params=PRESETS)
def raw_hf(request, tmp_path_factory):
    return _raw_dir(request.param, tmp_path_factory)


def _as_f32(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _flat_equal(jax_tree, port_tree):
    """Every leaf of the JAX tree equals the port's: same keys, shapes and
    values (floats compared in float32, where bf16 is exact)."""
    jf, tf = JW.flatten_params(jax_tree), TW.flatten_params(port_tree)
    assert jf.keys() == tf.keys()
    for key, want in jf.items():
        got = tf[key]
        assert tuple(got.shape) == tuple(np.shape(want)), key
        np.testing.assert_array_equal(_as_f32(got), _as_f32(want), err_msg=key)


# --- raw HF load (the repair: the parent raised ValueError here) ---------------


def test_load_params_reads_a_raw_hf_directory(raw_hf):
    """The port's ``load_params`` on a raw HF directory gives the JAX
    ``load_params``' tensors, and the tree the directory was written from."""
    name, path, params = raw_hf
    jcfg, jparams = JW.load_params(path)
    tcfg, tparams = TW.load_params(path)
    assert tcfg.architecture == jcfg.architecture and tcfg.dtype == "bfloat16"
    _flat_equal(jparams, tparams)
    qkv = tparams["model"]["layers"]["self_attn"]["qkv_proj"]["weight"]
    want = np.asarray(params["model"]["layers"]["self_attn"]["qkv_proj"]["weight"], np.float32)
    np.testing.assert_array_equal(qkv.float().numpy(), want.astype(jax.numpy.bfloat16).astype(np.float32))


def test_patch_embedding_is_transposed_once(tmp_path_factory, tmp_path):
    """The raw NCHW patch embedding loads as OHWI; a sanitized directory,
    which stores OHWI, loads as stored (no second transpose)."""
    _, path, params = _raw_dir("tiny_vision", tmp_path_factory)
    key = ["model", "vision_embed_tokens", "img_processor", "vision_model", "embeddings",
           "patch_embedding", "weight"]

    def leaf(tree):
        for k in key:
            tree = tree[k]
        return tree

    want = np.asarray(leaf(params), np.float32).astype(jax.numpy.bfloat16).astype(np.float32)
    e, p = want.shape[0], want.shape[1]
    assert want.shape == (e, p, p, 3) and p != 3
    raw_patch = TW.load_safetensors_dir(path)["model." + ".".join(key[1:])]
    assert tuple(raw_patch.shape) == (e, 3, p, p)
    np.testing.assert_array_equal(leaf(TW.load_params(path)[1]).float().numpy(), want)
    clean = str(tmp_path / "clean")
    TW.sanitize_checkpoint(path, clean)
    stored = TW.load_safetensors_dir(clean)["model." + ".".join(key[1:])]
    assert tuple(stored.shape) == (e, p, p, 3)
    np.testing.assert_array_equal(leaf(TW.load_params(clean)[1]).float().numpy(), want)


# --- sanitize_checkpoint ------------------------------------------------------


def test_sanitize_checkpoint_matches_jax(raw_hf, tmp_path):
    """Both packages sanitize one raw directory: the same config and tokenizer
    files, tensors equal byte for byte, and each package loads the other's
    output to the tensors of its own."""
    name, path, _ = raw_hf
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    JW.sanitize_checkpoint(path, jdir)
    cfg = TW.sanitize_checkpoint(path, tdir)
    assert cfg.dtype == "bfloat16"
    with open(f"{jdir}/config.json") as f, open(f"{tdir}/config.json") as g:
        jc, tc = json.load(f), json.load(g)
    assert jc == tc and tc["layout"] == "in_out"
    assert sorted(os.listdir(jdir)) == sorted(os.listdir(tdir))
    assert os.path.exists(f"{tdir}/tokenizer_config.json")
    jflat, tflat = TW.load_safetensors_dir(jdir), TW.load_safetensors_dir(tdir)
    assert jflat.keys() == tflat.keys()
    for key, want in jflat.items():
        got = tflat[key]
        assert got.dtype == want.dtype and got.shape == want.shape, key
        assert torch.equal(got.contiguous().view(torch.uint8), want.contiguous().view(torch.uint8)), key
    _flat_equal(JW.load_params(tdir)[1], TW.load_params(jdir)[1])
    _flat_equal(JW.load_params(jdir)[1], TW.load_params(tdir)[1])


# --- quantize_checkpoint from a raw directory ----------------------------------


@pytest.mark.parametrize("bits", [4, 8])
def test_quantize_checkpoint_of_a_raw_directory_matches_jax(raw_hf, tmp_path, bits):
    """``quantize_checkpoint`` straight from the raw directory (linears
    transposed as it loads): the JAX one's config, payloads, scales and
    biases exactly, and the JAX package loads the port's output."""
    name, path, _ = raw_hf
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    JW.quantize_checkpoint(path, jdir, q_bits=bits)
    cfg = TW.quantize_checkpoint(path, tdir, q_bits=bits)
    assert cfg.quantized.bits == bits
    with open(f"{jdir}/config.json") as f, open(f"{tdir}/config.json") as g:
        assert json.load(f) == json.load(g)
    jflat, tflat = TW.load_safetensors_dir(jdir), TW.load_safetensors_dir(tdir)
    assert jflat.keys() == tflat.keys()
    n_payload = 0
    for key, want in jflat.items():
        got = tflat[key]
        assert got.dtype == want.dtype and got.shape == want.shape, key
        n_payload += int(want.dtype == torch.uint8)
        assert torch.equal(got, want), (key, int((got != want).sum()))
    assert n_payload > 0
    _flat_equal(JW.load_params(tdir)[1], TW.load_params(tdir)[1])


# --- the native reader ----------------------------------------------------------

ALL_DTYPES = (torch.float64, torch.float32, torch.float16, torch.bfloat16, torch.int64, torch.int32,
              torch.int16, torch.int8, torch.uint8, torch.bool)


def _every_dtype(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    out = {}
    for i, dt in enumerate(ALL_DTYPES):
        shape = (3, 5, 2) if i % 2 else (7, 4)
        if dt == torch.bool:
            t = torch.from_numpy(rng.integers(0, 2, shape).astype(bool))
        elif dt.is_floating_point:
            t = torch.from_numpy(rng.standard_normal(shape)).to(dt)
        else:
            info = torch.iinfo(dt)
            t = torch.from_numpy(rng.integers(info.min, info.max, shape, dtype=np.int64)).to(dt)
        out[f"t.{str(dt).split('.')[-1]}"] = t
    out["scalar"] = torch.tensor(3.5)
    out["empty"] = torch.zeros((0, 4), dtype=torch.bfloat16)
    return out


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Same dtype, shape and bytes."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    return torch.equal(a.contiguous().reshape(-1).view(torch.uint8),
                       b.contiguous().reshape(-1).view(torch.uint8))


@needs_gxx
def test_native_reader_matches_the_python_reader(tmp_path):
    """Every dtype of the format, BF16 included, bit for bit against the
    pure-Python reader, and against the JAX package's native reader."""
    path = str(tmp_path / "t.safetensors")
    ref = _every_dtype()
    TW.save_safetensors(path, ref)
    nat, py = native.load_file_mmap(path), TW.load_safetensors(path)
    assert nat.keys() == py.keys() == ref.keys()
    for k in ref:
        assert _same(nat[k], py[k]) and _same(nat[k], ref[k]), k
    from phi_3_vision_mlx_tpu.core import native as jax_native

    if jax_native.available():
        jout = jax_native.load_file_mmap(path)
        np.testing.assert_array_equal(nat["t.bfloat16"].float().numpy(),
                                      np.asarray(jout["t.bfloat16"], np.float32))


@needs_gxx
def test_native_reader_copies_a_misaligned_tensor_and_is_copy_on_write(tmp_path):
    """A tensor at an offset its element size does not divide (the format
    allows it) reads right; writing a tensor in place leaves the file."""
    path = str(tmp_path / "odd.safetensors")
    a = np.arange(5, dtype=np.uint8)
    b = np.arange(6, dtype=np.float32) / 3
    header = {"a": {"dtype": "U8", "shape": [5], "data_offsets": [0, 5]},
              "b": {"dtype": "F32", "shape": [2, 3], "data_offsets": [5, 29]}}
    head = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)) + head + a.tobytes() + b.tobytes())
    out = native.load_file_mmap(path)
    np.testing.assert_array_equal(out["a"].numpy(), a)
    np.testing.assert_array_equal(out["b"].numpy(), b.reshape(2, 3))
    out["a"][0] = 99
    assert native.load_file_mmap(path)["a"][0] == 0 and TW.load_safetensors(path)["a"][0] == 0


@needs_gxx
def test_native_reader_errors(tmp_path):
    with pytest.raises(OSError, match="st_mmap failed"):
        native.load_file_mmap(str(tmp_path / "nope.safetensors"))
    bad = tmp_path / "bad.safetensors"
    bad.write_bytes(struct.pack("<Q", 1 << 40) + b"{}")
    with pytest.raises(OSError, match="header length"):
        native.load_file_mmap(str(bad))


@needs_gxx
def test_load_safetensors_dir_prefers_the_native_reader(tmp_path, monkeypatch, capsys):
    """``load_safetensors_dir`` reads with the native reader (the tensors
    alias its mapping, not a copy), says so once on stderr, and reads with
    the pure-Python reader under ``PHI3V_TPU_NATIVE_IO=0``."""
    ref = _every_dtype(1)
    TW.save_safetensors(str(tmp_path / "model-00000-of-00002.safetensors"), dict(list(ref.items())[:5]))
    TW.save_safetensors(str(tmp_path / "model-00001-of-00002.safetensors"), dict(list(ref.items())[5:]))
    monkeypatch.setattr(TW, "_READER_SAID", [])
    monkeypatch.delenv("PHI3V_TPU_NATIVE_IO", raising=False)
    assert TW.safetensors_reader()[0] == "native"
    calls = []
    monkeypatch.setattr(native, "load_file_mmap", lambda p, f=native.load_file_mmap: calls.append(p) or f(p))
    for _ in range(2):
        out = TW.load_safetensors_dir(str(tmp_path))
        assert out.keys() == ref.keys() and all(_same(out[k], ref[k]) for k in ref)
    assert len(calls) == 4
    assert capsys.readouterr().err.count("safetensors reader: native") == 1
    monkeypatch.setenv("PHI3V_TPU_NATIVE_IO", "0")
    assert TW.safetensors_reader()[0] == "python"
    out = TW.load_safetensors_dir(str(tmp_path))
    assert all(_same(out[k], ref[k]) for k in ref) and len(calls) == 4
    assert capsys.readouterr().err.count("safetensors reader: python") == 1
    with pytest.raises(FileNotFoundError):
        TW.load_safetensors_dir(str(tmp_path / "empty"))


def test_reader_without_gxx_is_the_python_one(monkeypatch):
    """Where g++ is missing the native reader reports itself unavailable
    and ``load_safetensors_dir`` reads in pure Python."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_SO", "/nonexistent/libst_mmap.so")
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    assert not native.available()
    monkeypatch.delenv("PHI3V_TPU_NATIVE_IO", raising=False)
    assert TW.safetensors_reader()[0] == "python"
