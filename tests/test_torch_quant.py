"""The port's quantization, weight layout and kernel K1's plain version
against the JAX package.

Inputs come from ``np.random.default_rng`` and go to both packages.  K1's
plain version is held against the JAX Pallas kernels ``quant_matmul_tiled``
and ``quant_matmul_tiled_stacked`` run with ``interpret=True`` on the CPU,
as tests/test_quant_kernels.py runs them.  Scales and biases are rounded to
bf16 on both sides (the TPU kernels store them as bf16, the port too).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from phi_3_vision_mlx_tpu.core.config import QuantConfig, preset  # noqa: E402
from phi_3_vision_mlx_tpu.ops import quant as JQ  # noqa: E402
from phi_3_vision_mlx_tpu.ops.kernels import quant_matmul as JK  # noqa: E402
from phi_3_vision_mlx_tpu_torch.core import weights as TW  # noqa: E402
from phi_3_vision_mlx_tpu_torch.ops import linear as TL  # noqa: E402
from phi_3_vision_mlx_tpu_torch.ops import quant as TQ  # noqa: E402
from phi_3_vision_mlx_tpu_torch.ops.kernels import quant_matmul as TK  # noqa: E402

GROUP = 64
K, N = 512, 512  # the JAX tiled layout needs multiples of its 512 blocks


def _weights(seed, k=K, n=N, lead=()):
    return (np.random.default_rng(seed).standard_normal((*lead, k, n)) * 0.02).astype(np.float32)


def _jax_qtensor(w, mode):
    t = JQ.quantize(jnp.asarray(w), GROUP, 4, mode=mode)
    bf = lambda a: None if a is None else np.array(a.astype(jnp.bfloat16).astype(jnp.float32))  # noqa: E731
    return np.array(t.q), bf(t.scales), bf(t.biases)


def _port_leaf(q, s, b):
    node = {"weight": torch.from_numpy(q), "scales": torch.from_numpy(s)}
    if b is not None:
        node["biases"] = torch.from_numpy(b)
    return TW.prepare_linear(node)


@pytest.mark.parametrize("mode", ["affine", "symmetric"])
def test_quantize_matches_jax(mode):
    w = _weights(0, 256, 192)
    jt = JQ.quantize(jnp.asarray(w), GROUP, 4, mode=mode)
    tt = TQ.quantize(torch.from_numpy(w), GROUP, 4, mode=mode)
    # Same f32 arithmetic on both sides: payload and scales must be identical.
    np.testing.assert_array_equal(tt.q.numpy(), np.asarray(jt.q))
    np.testing.assert_array_equal(tt.scales.numpy(), np.asarray(jt.scales))
    assert (tt.biases is None) == (jt.biases is None)
    if jt.biases is not None:
        np.testing.assert_array_equal(tt.biases.numpy(), np.asarray(jt.biases))


@pytest.mark.parametrize("mode", ["affine", "symmetric"])
def test_dequantize_and_quantized_matmul_match_jax(mode):
    q, s, b = _jax_qtensor(_weights(1), mode)
    x = np.random.default_rng(2).standard_normal((5, K)).astype(np.float32)
    jt = JQ.QTensor(jnp.asarray(q), jnp.asarray(s), None if b is None else jnp.asarray(b))
    tt = TQ.QTensor(torch.from_numpy(q), torch.from_numpy(s), None if b is None else torch.from_numpy(b))
    # f32 dequantization is elementwise and identical on both sides.
    np.testing.assert_array_equal(
        TQ.dequantize(tt, dtype=torch.float32).numpy(),
        np.asarray(JQ.dequantize(jt, dtype=jnp.float32)),
    )
    # f32 matmul: only the summation order differs.
    np.testing.assert_allclose(
        TQ.quantized_matmul(torch.from_numpy(x), tt).numpy(),
        np.asarray(JQ.quantized_matmul(jnp.asarray(x), jt)),
        rtol=1e-5, atol=1e-5,
    )


def test_pack_int4_roundtrip_and_layout():
    q = np.random.default_rng(3).integers(0, 16, (3, 128, 40), dtype=np.uint8)
    words = TW.pack_int4(torch.from_numpy(q))
    assert words.dtype == torch.int32 and words.shape == (3, 16, 40)
    np.testing.assert_array_equal(TW.unpack_int4(words).numpy(), q)
    # nibble j of word [r, n] holds q[8r + j, n]
    w0 = int(words[1, 2, 7]) & 0xFFFFFFFF
    assert [(w0 >> (4 * j)) & 15 for j in range(8)] == list(q[1, 16:24, 7])


@pytest.mark.parametrize("mode", ["affine", "symmetric"])
def test_prepare_params_layout_roundtrip(mode):
    q, s, b = _jax_qtensor(_weights(4, lead=(2,)), mode)
    cfg = preset("tiny").replace(quantized=QuantConfig(GROUP, 4, mode))
    node = {"weight": torch.from_numpy(q), "scales": torch.from_numpy(s), "bias": torch.zeros(N)}
    if b is not None:
        node["biases"] = torch.from_numpy(b)
    emb = {"weight": torch.from_numpy(q[0].T.copy()), "scales": torch.from_numpy(s[0].T.copy())}
    out = TW.prepare_params({"lin": node, "embed": emb, "norm": {"weight": torch.ones(4)}}, cfg)
    lin = out["lin"]
    assert lin["qweight"].shape == (2, K // 8, N) and lin["scales"].dtype == torch.bfloat16
    assert "weight" not in lin and "bias" in lin and (("biases" in lin) == (b is not None))
    np.testing.assert_array_equal(TW.unpack_int4(lin["qweight"]).numpy(), q)
    np.testing.assert_array_equal(lin["scales"].float().numpy(), s)
    assert out["embed"]["weight"].dtype == torch.uint8  # embeddings keep (V, E)
    assert out["embed"]["scales"].dtype == torch.bfloat16


@pytest.mark.parametrize("m", [1, 3, 300])
@pytest.mark.parametrize("mode", ["affine", "symmetric"])
def test_k1_plain_matches_jax_tiled_kernel(mode, m):
    q, s, b = _jax_qtensor(_weights(5), mode)
    x = np.random.default_rng(6).standard_normal((m, K)).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    tiles = JK.to_tiled_layout(jnp.asarray(q), jnp.asarray(s), None if b is None else jnp.asarray(b))
    ref = JK.quant_matmul_tiled(
        JK.permute_activation(xb, GROUP), *tiles, out_dtype=jnp.float32, interpret=True
    )
    leaf = _port_leaf(q, s, b)
    xt = torch.from_numpy(np.array(xb.astype(jnp.float32))).to(torch.bfloat16)
    out = TK.quant_matmul(xt, leaf["qweight"], leaf["scales"], leaf.get("biases"), torch.float32)
    # Both round W to bf16 and accumulate bf16 x bf16 products in f32; only
    # the f32 summation order differs (outputs are O(1)).
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("m", [1, 3, 300])
@pytest.mark.parametrize("mode", ["affine", "symmetric"])
def test_k1_plain_matches_jax_tiled_stacked_kernel(mode, m):
    nl = 3
    q, s, b = _jax_qtensor(_weights(7, lead=(nl,)), mode)
    tiled = [
        JK.to_tiled_layout(jnp.asarray(q[i]), jnp.asarray(s[i]), None if b is None else jnp.asarray(b[i]))
        for i in range(nl)
    ]
    q_st = jnp.stack([t[0] for t in tiled])
    s_st = jnp.stack([t[1] for t in tiled])
    b_st = None if b is None else jnp.stack([t[2] for t in tiled])
    x = np.random.default_rng(8).standard_normal((m, K)).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    xt = torch.from_numpy(np.array(xb.astype(jnp.float32))).to(torch.bfloat16)
    leaf = _port_leaf(q, s, b)
    for layer in (0, nl - 1):
        ref = JK.quant_matmul_tiled_stacked(
            JK.permute_activation(xb, GROUP), q_st, s_st, b_st, layer,
            out_dtype=jnp.float32, interpret=True,
        )
        view = TL.layer_view(leaf, layer)
        out = TK.quant_matmul(xt, view["qweight"], view["scales"], view.get("biases"), torch.float32)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("mode", ["affine", "symmetric"])
def test_dense_regimes_and_embedding_match_jax(mode):
    """``dense`` below and above 256 rows, and the quantized embedding."""
    from phi_3_vision_mlx_tpu.ops import linear as JL

    q, s, b = _jax_qtensor(_weights(9), mode)
    leaf = _port_leaf(q, s, b)
    jleaf = {"weight": jnp.asarray(q), "scales": jnp.asarray(s)}
    if b is not None:
        jleaf["biases"] = jnp.asarray(b)
    for rows in (7, 260):
        x = np.random.default_rng(rows).standard_normal((1, rows, K)).astype(np.float32)
        np.testing.assert_allclose(
            TL.dense(leaf, torch.from_numpy(x)).numpy(),
            np.asarray(JL.dense(jleaf, jnp.asarray(x))),
            rtol=1e-5, atol=1e-5,
        )
    # embedding: (V, E) payload with groups along E
    ids = np.array([[3, 0, 511, 3]])
    emb = {"weight": q.T.copy(), "scales": s.T.copy()}
    if b is not None:
        emb["biases"] = b.T.copy()
    ref = JL.embedding({k: jnp.asarray(v) for k, v in emb.items()}, jnp.asarray(ids))
    out = TL.embedding({k: torch.from_numpy(v) for k, v in emb.items()}, torch.from_numpy(ids))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_k1_wrapper_has_no_silent_fallback():
    """A tensor that is neither on the CPU nor on CUDA raises; the plain
    version runs only for CPU tensors."""
    x = torch.empty((1, K), dtype=torch.bfloat16, device="meta")
    qw = torch.empty((K // 8, N), dtype=torch.int32, device="meta")
    s = torch.empty((K // GROUP, N), dtype=torch.bfloat16, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        TK.quant_matmul(x, qw, s)
    assert TK.quant_matmul.launches == 0


def test_k1_split_plan_covers_every_group():
    for m, k, n in [(1, 3072, 9216), (1, 8192, 3072), (64, 3072, 32064), (256, 3072, 3072), (1, 64, 5)]:
        splits, per = TK._splits(m, k, n)
        groups = k // GROUP
        assert splits * per >= groups and (splits - 1) * per < groups


def test_synth_quantized_params_shapes():
    cfg = preset("tiny").replace(quantized=QuantConfig(GROUP, 4, "symmetric"))
    p = TW.synth_quantized_params(cfg, device="cpu", seed=0)
    qkv = p["model"]["layers"]["self_attn"]["qkv_proj"]
    e, d = cfg.hidden_size, cfg.head_dim
    op = (cfg.num_attention_heads + 2 * cfg.num_key_value_heads) * d
    assert qkv["qweight"].shape == (cfg.num_hidden_layers, e // 8, op)
    assert qkv["scales"].shape == (cfg.num_hidden_layers, e // GROUP, op) and "biases" not in qkv
    assert p["lm_head"]["qweight"].shape == (e // 8, cfg.vocab_size)
    again = TW.synth_quantized_params(cfg, device="cpu", seed=0)
    assert torch.equal(again["lm_head"]["qweight"], p["lm_head"]["qweight"])


def test_safetensors_roundtrip_is_readable_by_both(tmp_path):
    from phi_3_vision_mlx_tpu.core.weights import load_safetensors_dir as jax_load

    flat = {
        "a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
        "b": torch.tensor([1.5, -2.25], dtype=torch.bfloat16),
        "c": torch.arange(10, dtype=torch.uint8),
        "d": torch.tensor([-(2**31), 7], dtype=torch.int32),
        "e": torch.arange(3, dtype=torch.uint8),  # odd byte count before wider dtypes
    }
    TW.save_safetensors(str(tmp_path / "m.safetensors"), flat)
    back = TW.load_safetensors_dir(str(tmp_path))
    for k, v in flat.items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v)
    ref = jax_load(str(tmp_path))
    np.testing.assert_array_equal(np.asarray(ref["b"], dtype=np.float32), [1.5, -2.25])
    np.testing.assert_array_equal(ref["d"], [-(2**31), 7])
    # A file whose tensors are not aligned to their element size still reads.
    TW.save_safetensors(str(tmp_path / "m.safetensors"), {"a": flat["e"], "b": flat["a"]})
    import json, struct  # noqa: E401
    path = tmp_path / "m.safetensors"
    data = path.read_bytes()
    (n,) = struct.unpack("<Q", data[:8])
    header = json.loads(data[8 : 8 + n])
    blob = data[8 + n :]
    fa, fe = header["b"]["data_offsets"], header["a"]["data_offsets"]
    header["a"]["data_offsets"], header["b"]["data_offsets"] = [0, 3], [3, 3 + fa[1] - fa[0]]
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    path.write_bytes(struct.pack("<Q", len(head)) + head + blob[fe[0] : fe[1]] + blob[fa[0] : fa[1]])
    back = TW.load_safetensors(str(path))
    assert torch.equal(back["a"], flat["e"]) and torch.equal(back["b"], flat["a"])
