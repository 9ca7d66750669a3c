"""The port's quantization, weight layout and kernel K1's plain version
against the JAX package.

Inputs come from ``np.random.default_rng`` and go to both packages.  K1's
plain version is held against the JAX Pallas kernels ``quant_matmul_tiled``
and ``quant_matmul_tiled_stacked`` run with ``interpret=True`` on the CPU,
as tests/test_quant_kernels.py runs them.  Scales and biases are rounded to
bf16 on both sides (the TPU kernels store them as bf16, the port too).
"""

import inspect

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
from phi_3_vision_mlx_tpu_torch.ops.kernels import w4a8 as TE1  # noqa: E402

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
    """Every split plan (K1's, K8's and K9's ``plan``, and E1's, on their
    route) covers each group once, with no empty split; route A's staged x
    fits its 16 KB (E1's x8 its 4 KB), its four warps get equal shares where
    the groups allow, and its second pass adds at most 32 partial sums.  E1
    takes route A at one row only, with K1's plan; on route B it aims at
    fewer blocks than K1, so it splits K no more than K1 does."""
    cases = [(1, 3072, 9216), (1, 8192, 3072), (2, 8192, 3072), (64, 3072, 32064), (256, 3072, 3072),
             (1, 64, 5), (1, 3072, 32064), (192, 3072, 9216), (17, 8192, 3072), (16, 3072, 9216)]
    for m, k, n in cases:
        groups = k // GROUP
        plans = [(TE1.route(m), TE1.plan(m, k, n))]
        if m == 1:
            assert plans[0][1] == TK.plan(m, k, n, "k1")
        else:
            assert plans[0][1][0] <= TK.plan(m, k, n, "k1")[0]
        for layout in ("k1", "k8", "k9"):
            plans.append((TK.route(m, layout), TK.plan(m, k, n, layout)))
        for rt, (splits, per) in plans:
            assert splits * per >= groups and (splits - 1) * per < groups
            if rt == "a":
                assert per <= 64 and splits <= 32
                assert per % 4 == 0 or per == groups
    assert TE1.route(1) == "a" and all(TE1.route(m) == "b" for m in range(2, 257))
    assert "route" not in inspect.signature(TE1.w4a8_matmul).parameters


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


# --- K1 and K9 as the card computes them (csrc/quant_matmul.cu), modelled in
# plain PyTorch: the CUDA kernels run only on the card, where chip_smoke.py
# holds them to the plain versions; here their decomposition is held to the
# plain versions at narrow widths -------------------------------------------


def _level(byte, affine):
    """The kernel's ``level()``: the byte as the low mantissa bits of 2^23,
    minus 2^23 (affine) or 2^23 + 8 (symmetric), which is exact."""
    return (byte.to(torch.int32) | 0x4B000000).view(torch.float32) - (2.0**23 if affine else 2.0**23 + 8)


def _weight(lv, s, b):
    """``dequant()`` then one rounding to bf16: s * lv and + b, each rounded."""
    w = s.float() * lv
    return (w if b is None else w + b.float()).to(torch.bfloat16)


def _lo_hi(v, mask):
    """Nibble 2e of ``v`` in byte e of lo, nibble 2e + 1 in byte e of hi."""
    v = v.to(torch.int64) & 0xFFFFFFFF
    return v & mask, (v >> 4) & mask


def _byte(v, e):
    return (v >> (8 * e)) & 0xFF


def _route_a_model(x, qw, s, b, layout="k1"):
    """Route A (one row) of K1 (``layout="k1"``, (K/8, N) words) or K8
    (``"k8"``, (K/4, N) words): lane l of block x owns the columns 4 (32 x +
    l) .. + 3; a split's four warps take its groups g0 + w, g0 + w + 4, ...;
    4 bits: byte e of word row r gives rows 8 r + 2 e (lo) and 8 r + 2 e + 1
    (hi); 8 bits: a group is two units of eight word rows (the second reusing
    the first's scales and biases), byte e of word row r giving row 4 r + e;
    the warps' f32 sums are added in order, then the splits'.  Returns (out,
    the W it multiplied, how many lanes own each column)."""
    m, k = x.shape
    n = qw.shape[1]
    owners = torch.zeros(-(-n // 128) * 128, dtype=torch.int64)
    lanes = torch.arange(owners.numel() // 4)
    owners.index_add_(0, (4 * lanes[:, None] + torch.arange(4)).flatten(), torch.ones(owners.numel(), dtype=torch.int64))
    assert TK.route(m, layout) == "a"
    splits, per = TK.plan(m, k, n, layout)
    xf, w_used, out = x.float(), torch.zeros((k, n), dtype=torch.bfloat16), torch.zeros((m, n))
    for sp in range(splits):
        g0, g1 = sp * per, min(k // GROUP, (sp + 1) * per)
        total = torch.zeros((m, n))
        for warp in range(4):
            acc = torch.zeros((m, n))
            for g in range(g0 + warp, g1, 4):
                if layout == "k1":
                    lo, hi = _lo_hi(qw[g * 8:(g + 1) * 8], 0x0F0F0F0F)  # (word row r, n)
                    lv = torch.stack([torch.stack([_byte(lo, e), _byte(hi, e)], 1) for e in range(4)], 1)
                    units = [(0, lv.reshape(64, n))]  # row 8 r + 2 e + (0 lo, 1 hi)
                else:
                    words = qw[g * 16:(g + 1) * 16].to(torch.int64) & 0xFFFFFFFF
                    units = [(32 * h, torch.stack([_byte(words[8 * h:8 * h + 8], e) for e in range(4)], 1).reshape(32, n))
                             for h in range(2)]  # row 4 r + e of the half
                for r0, lv in units:
                    w_u = _weight(_level(lv, b is not None), s[g], None if b is None else b[g])
                    rows = slice(g * 64 + r0, g * 64 + r0 + lv.shape[0])
                    w_used[rows] = w_u
                    acc = acc + xf[:, rows] @ w_u.float()
            total = total + acc
        out = out + total
    return out, w_used, owners[:n]


# The thread coordinates of a route-B warp's B fragments: (warp, gid, t, s, j,
# e), and the group row k = 16 t + 4 s + e each holds (the kernel's k order).
_WARP, _GID, _T, _S, _J, _E = torch.meshgrid(*(torch.arange(v) for v in (4, 8, 4, 4, 4, 4)), indexing="ij")
_KSLOT = 16 * _T + 4 * _S + _E
# The mma's k index of (t, e) (A and B alike: a0/b0 hold e = 0, 1 at 2 t, 2 t
# + 1; a2/b1 e = 2, 3 at 2 t + 8, 2 t + 9), as the order of the 16 (t, e).
_TE_OF_KK = torch.argsort(torch.tensor([2 * t + (e & 1) + 8 * (e >> 1) for t in range(4) for e in range(4)]))
_A_KSLOT = (16 * torch.arange(4)[None, :, None] + 4 * torch.arange(4)[:, None, None]
            + torch.arange(4)[None, None, :]).reshape(4, 16)[:, _TE_OF_KK]  # [s][kk] -> group row


def _route_b_model(x, layout, payload, s, b, w_ref):
    """Route B as the card computes it, for K1's words (``layout="k1"``),
    K8's (``"k8"``) or K9's packed bytes (``"k9"``): 128-column tiles, the
    plan's K splits; per
    group, the staged scales, each thread's B fragments (levels picked by
    byte as the kernel's loaders do), held bit for bit to ``w_ref`` (the
    plain dequantized W); the mma's k slots fed from x in the same order;
    outputs written through the loaders' two runs of four columns.  Returns
    out (f32)."""
    m, k = x.shape
    n = s.shape[1]
    affine = b is not None
    assert TK.route(m, layout) == "b"
    splits, per = TK.plan(m, k, n, layout)
    xf = x.float()
    out = torch.zeros((splits, m, n))
    for tile in range(-(-n // 128)):
        if layout != "k9":
            col_of = tile * 128 + 32 * _WARP + 4 * _GID + _J  # WordTiles
            scale_cols = tile * 128 + torch.arange(128)
            idx = 32 * _WARP + 4 * _GID + _J
        else:
            lo0 = (tile // 4) * 512 + (tile % 4) * 64  # PackedTiles
            col_of = lo0 + 256 * (_J // 2) + 16 * _WARP + 2 * _GID + (_J & 1)
            c8 = torch.arange(16)
            scale_cols = (lo0 + torch.where(c8 < 8, 8 * c8, 256 + 8 * (c8 - 8))[:, None] + torch.arange(8)).flatten()
            idx = (_J // 2) * 64 + 16 * _WARP + 2 * _GID + (_J & 1)
        valid, col_c = col_of < n, col_of.clamp(max=n - 1)
        for sp in range(splits):
            # every group of the split at once: leading axis g
            gs = torch.arange(sp * per, min(k // GROUP, (sp + 1) * per))
            gx = gs.view(-1, *[1] * _KSLOT.dim())
            staged = [torch.where(scale_cols < n, p[gs][:, scale_cols.clamp(max=n - 1)].float(), 0.0)
                      for p in ((s, b) if affine else (s,))]
            sj, bj = staged[0][:, idx], staged[1][:, idx] if affine else None
            if layout == "k1":
                word = torch.where(valid, payload[gx * 8 + 2 * _T + _S // 2, col_c], 0)
                lo, hi = _lo_hi(word, 0x0F0F0F0F)
                lv = _byte(torch.where(_E % 2 == 0, lo, hi), 2 * (_S % 2) + _E // 2)
            elif layout == "k8":  # word row 4 t + s, byte e: row 16 t + 4 s + e
                word = torch.where(valid, payload[gx * 16 + 4 * _T + _S, col_c], 0).to(torch.int64) & 0xFFFFFFFF
                lv = _byte(word, _E)
            else:
                gk = min(512, k) // GROUP
                row = (gx // gk) * min(512, k) + _KSLOT * gk + gx % gk
                byte0 = (tile // 4) * 256 + (tile % 4) * 64 + 16 * _WARP + 2 * _GID
                v = payload[row, byte0].to(torch.int64) | (payload[row, byte0 + 1].to(torch.int64) << 8)
                lo, hi = _lo_hi(v, 0x0F0F)
                lv = _byte(torch.where(_J < 2, lo, hi), _J & 1)
            frag = _weight(_level(lv, affine), sj, bj)
            want = w_ref[gx * 64 + _KSLOT, col_c]
            assert torch.equal(frag[:, valid].view(torch.int16), want[:, valid].view(torch.int16))
            # B [g][warp][s][kk][nn = gid][j] and A [row][g][s][kk], both in the mma's k order
            bmat = frag.float().permute(0, 1, 4, 3, 6, 2, 5).reshape(len(gs), 4, 4, 16, 8, 4)[:, :, :, _TE_OF_KK]
            a = xf[:, gs[:, None, None] * 64 + _A_KSLOT]
            acc = torch.einsum("rgsk,gwsknj->rwnj", a, bmat)  # [row][warp][nn][j]
            # the epilogue: thread t writes the mma's columns 2 t and 2 t + 1
            # of its four n-tiles as two runs of four output columns
            for warp in range(4):
                for t in range(4):
                    for which in range(2):
                        for i in range(4):
                            if layout != "k9":
                                j, cc = i, which
                                col = tile * 128 + 32 * warp + 8 * t + 4 * which + i
                            else:
                                j, cc = 2 * which + (i & 1), i >> 1
                                col = lo0 + 256 * which + 16 * warp + 4 * t + i
                            assert col == col_of[warp, 2 * t + cc, 0, 0, j, 0]
                            if col < n:
                                out[sp, :, col] = acc[:, warp, 2 * t + cc, j]
    total = torch.zeros((m, n))
    for sp in range(splits):
        total = total + out[sp]
    return total


def _levels_and_planes(seed, k, n, mode):
    """Random 4-bit levels and bf16 scales (and biases, affine) of the
    synthetic weights' magnitude."""
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.integers(0, 16, (k, n), dtype=np.uint8))
    s = torch.from_numpy(0.004 * (1 + 0.1 * rng.standard_normal((k // GROUP, n)))).to(torch.bfloat16)
    b = torch.from_numpy(-0.03 + 0.001 * rng.standard_normal((k // GROUP, n))).to(torch.bfloat16)
    return q, s, (b if mode == "affine" else None)


def _bf16_x(seed, m, k):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal((m, k)).astype(np.float32)).to(
        torch.bfloat16)


# (K, N) at narrow widths: N off the 128-column blocks (lm_head's ragged
# edge), and 128 groups (down_proj's K = 8192).
K1_MODEL_SHAPES = {"ragged-n": (512, 520), "128-groups": (8192, 128)}
MODEL_TOL = dict(rtol=1e-5, atol=1e-5)  # f32 sums in another order, outputs O(1)


@pytest.mark.parametrize("mode", ["affine", "symmetric"])
@pytest.mark.parametrize("shape", list(K1_MODEL_SHAPES))
def test_k1_route_a_model_matches_plain(shape, mode):
    """K1's route A (M = 1): every column owned by exactly one lane, every
    weight it multiplies equal bit for bit to ``dequantize``, and its split
    plan's sums equal to the plain version's in f32."""
    k, n = K1_MODEL_SHAPES[shape]
    m = 1
    q, s, b = _levels_and_planes(m + 10 * len(shape), k, n, mode)
    x = _bf16_x(m, m, k)
    qw = TW.pack_int4(q)
    out, w_used, owners = _route_a_model(x, qw, s, b)
    assert (owners == 1).all()
    w_ref = TQ.dequantize(TQ.QTensor(q, s, b), dtype=torch.bfloat16)
    assert torch.equal(w_used.view(torch.int16), w_ref.view(torch.int16))
    ref = TK.quant_matmul_plain(x, qw, s, b, torch.float32)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), **MODEL_TOL)


@pytest.mark.parametrize("m", [2, 4, 8, 15, 17, 70, 256])
@pytest.mark.parametrize("mode", ["affine", "symmetric"])
@pytest.mark.parametrize("shape", list(K1_MODEL_SHAPES))
def test_k1_route_b_model_matches_plain(shape, mode, m):
    """K1's route B: the B fragments each thread dequantizes from the staged
    word tile are ``dequantize``'s bf16 W bit for bit (checked inside the
    model, ragged edge excluded), the mma's k order pairs them with the right
    x, and the output runs land on the right columns: equal to the plain
    version in f32 over row tiles of 16 (M = 2-15 included), 32 and 64 (two
    and four of them)."""
    k, n = K1_MODEL_SHAPES[shape]
    q, s, b = _levels_and_planes(m + 10 * len(shape), k, n, mode)
    x = _bf16_x(m, m, k)
    qw = TW.pack_int4(q)
    w_ref = TQ.dequantize(TQ.QTensor(q, s, b), dtype=torch.bfloat16)
    out = _route_b_model(x, "k1", qw, s, b, w_ref)
    ref = TK.quant_matmul_plain(x, qw, s, b, torch.float32)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), **MODEL_TOL)


def test_route_pick_and_its_limits():
    """The route: K1's and K8's route A (the GEMV) at one row only, route B
    from two rows on and for K9 at every M; K1 and K8 share a plan at every
    M; the wrappers leave the choice to M (no argument forces a route)."""
    for layout in ("k1", "k8"):
        assert TK.route(1, layout) == "a"
        assert all(TK.route(m, layout) == "b" for m in range(2, 257))
    assert all(TK.route(m, "k9") == "b" for m in range(1, 257))
    assert all(TK.plan(m, k, n, "k8") == TK.plan(m, k, n, "k1")
               for m in (1, 2, 17, 192) for k, n in ((3072, 9216), (8192, 3072), (3072, 32064)))
    for fn in (TK.quant_matmul, TK.quant_matmul_w8, TK.quant_matmul_packed):
        assert "route" not in inspect.signature(fn).parameters


# --- K8 on both routes (csrc/quant_matmul.cu: route A's 8-bit units, route
# B's WordTiles<8>), modelled as K1's above -------------------------------


def _k8_weights(seed, k, n):
    """Random 8-bit levels over 0..255 and the synthetic 8-bit weights'
    scales (the 4-bit step cut by 15/255) and biases, drawn per column."""
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.integers(0, 256, (k, n), dtype=np.uint8))
    s = torch.from_numpy(0.004 * 15 / 255 * (1 + 0.1 * rng.standard_normal((k // GROUP, n)))).to(torch.bfloat16)
    b = torch.from_numpy(-0.03 + 0.001 * rng.standard_normal((k // GROUP, n))).to(torch.bfloat16)
    return q, s, b


@pytest.mark.parametrize("shape", list(K1_MODEL_SHAPES))
def test_k8_route_a_model_matches_plain(shape):
    """K8's route A (M = 1): every column owned by exactly one lane, every
    weight of both half-group units equal bit for bit to ``dequantize`` over
    levels 0..255, and the split plan's sums equal to the plain version's in
    f32, at a ragged N and at 128 groups."""
    k, n = K1_MODEL_SHAPES[shape]
    q, s, b = _k8_weights(len(shape), k, n)
    assert int(q.min()) == 0 and int(q.max()) == 255
    x = _bf16_x(1, 1, k)
    qw = TW.pack_int8(q)
    out, w_used, owners = _route_a_model(x, qw, s, b, layout="k8")
    assert (owners == 1).all()
    w_ref = TQ.dequantize(TQ.QTensor(q, s, b), dtype=torch.bfloat16)
    assert torch.equal(w_used.view(torch.int16), w_ref.view(torch.int16))
    ref = TK.quant_matmul_w8_plain(x, qw, s, b, torch.float32)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), **MODEL_TOL)


@pytest.mark.parametrize("m", [2, 4, 15, 17, 70, 256])
@pytest.mark.parametrize("shape", list(K1_MODEL_SHAPES))
def test_k8_route_b_model_matches_plain(shape, m):
    """K8's route B: each thread's B fragments, byte e of word row 4 t + s
    for k-step s, are ``dequantize``'s bf16 W bit for bit over levels 0..255
    (checked inside the model, ragged edge excluded), and the tile walk
    equals the plain version in f32 over row tiles of 16, 32 and 64."""
    k, n = K1_MODEL_SHAPES[shape]
    q, s, b = _k8_weights(m + len(shape), k, n)
    x = _bf16_x(m, m, k)
    qw = TW.pack_int8(q)
    w_ref = TQ.dequantize(TQ.QTensor(q, s, b), dtype=torch.bfloat16)
    out = _route_b_model(x, "k8", qw, s, b, w_ref)
    ref = TK.quant_matmul_w8_plain(x, qw, s, b, torch.float32)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), **MODEL_TOL)


# WordTiles<BITS> (csrc/quant_matmul.cu): (row stride in bytes, the slot of
# word row r, the word rows thread t reads for its four k-steps).
WORD_TILES = {4: (528, lambda r: r, lambda t: [2 * t, 2 * t, 2 * t + 1, 2 * t + 1]),
              8: (544, lambda r: 4 * (r % 4) + r // 4, lambda t: [4 * t + s for s in range(4)])}


@pytest.mark.parametrize("bits", [4, 8])
def test_word_tile_reads_are_conflict_free(bits):
    """Route B's word tiles: every word row of a group has its own 16-byte
    aligned slot, and each quarter-warp's 16-byte fragment reads (lanes 4 gid
    + t, eight at a time) fall in eight distinct 16-byte bank groups."""
    stride, slot, rows_of = WORD_TILES[bits]
    n_rows = 2 * bits
    assert sorted(slot(r) for r in range(n_rows)) == list(range(n_rows)) and stride % 16 == 0
    for warp in range(4):
        for step in range(4):
            for quarter in range(4):
                lanes = range(8 * quarter, 8 * quarter + 8)
                addr = [slot(rows_of(lane % 4)[step]) * stride + warp * 128 + (lane // 4) * 16 for lane in lanes]
                assert len({a // 16 % 8 for a in addr}) == 8, (bits, warp, step, quarter)


# --- E1 on both routes (csrc/w4a8_matmul.cu), modelled at the level of its
# integer instructions: dp4a, the byte permutes and the m16n8k32 s8 fragments
# as PTX lays them out.  Words are int64 holding the 32 unsigned bits. ------

_M4 = 0x0F0F0F0F  # the low nibble of each byte
_ONES = 0x01010101
_MAGIC_BITS = 0x4B400000  # 1.5 * 2^23 as f32


def _bytes_of(w):
    """Words -> their four bytes, unsigned, low byte first."""
    return (w[..., None] >> (8 * torch.arange(4))) & 0xFF


def _signed(b):
    return b - 256 * (b >= 128)


def _word(b):
    """(..., 4) bytes -> the word."""
    return (b.to(torch.int64) << (8 * torch.arange(4))).sum(-1)


def _byte_perm(x, y, sel):
    """CUDA's __byte_perm: byte i of the result is byte (sel >> 4 i) & 7 of y:x."""
    b = torch.cat([_bytes_of(x), _bytes_of(y)], -1)
    return _word(torch.stack([b[..., (sel >> (4 * i)) & 7] for i in range(4)], -1))


def _dp4a(a, b, c, a_signed):
    """c + the four products of a's bytes (signed, or unsigned: dp4a.u32.s32)
    and b's signed bytes."""
    ab = _bytes_of(torch.as_tensor(a))
    return c + ((_signed(ab) if a_signed else ab) * _signed(_bytes_of(torch.as_tensor(b)))).sum(-1)


def _x8_words(x8):
    """x8 (M, K) int8 -> (M, K/4) words, word i holding x8[:, 4 i .. 4 i + 3]."""
    m, k = x8.shape
    return _word((x8.to(torch.int64) & 0xFF).reshape(m, k // 4, 4))


def _e1_group_sums(x8, qw):
    """The plain version's exact per-group products x8 . (q - 8): (G, M, N) int64."""
    m, k = x8.shape
    q = TW.unpack_int4(qw).to(torch.int64) - 8
    return torch.einsum("mgk,gkn->gmn", x8.to(torch.int64).reshape(m, k // GROUP, GROUP),
                        q.reshape(k // GROUP, GROUP, -1))


def _e1_route_a_model(x8, sx, qw, s):
    """E1's route A (one row): the block's x8 staged run by run (rows 0, 2,
    4, 6 then 1, 3, 5, 7 of each 8-row run, by byte permutes) with each
    group's sum from its eight runs; per group and column, two dp4a.u32.s32
    per word row (its low and high nibbles against the two staged words),
    less 8 sum(x8), held exactly to the plain version's group sums; a split's
    four warps take its groups g0 + w, g0 + w + 4, ..., their f32 sums added
    in warp order, times sx, then the splits' in order."""
    m, k = x8.shape
    n, groups = qw.shape[1], k // GROUP
    assert m == 1 and TE1.route(m) == "a"
    splits, per = TE1.plan(m, k, n)
    xw = _x8_words(x8)[0]
    lo, hi = xw[0::2], xw[1::2]  # run c: x8 bytes 8 c .. 8 c + 3 and 8 c + 4 .. 8 c + 7
    staged = torch.stack([_byte_perm(lo, hi, 0x6420), _byte_perm(lo, hi, 0x7531)], 1)
    xsum = _dp4a(lo, _ONES, _dp4a(hi, _ONES, 0, True), True).reshape(groups, 8).sum(1)
    words = qw.to(torch.int64) & 0xFFFFFFFF
    want = _e1_group_sums(x8, qw)[:, 0]
    out = torch.zeros(n)
    for sp in range(splits):
        g0, g1 = sp * per, min(groups, (sp + 1) * per)
        total = None
        for warp in range(4):
            acc = torch.zeros(n)
            for g in range(g0 + warp, g1, 4):
                isum = torch.zeros(n, dtype=torch.int64)
                for r in range(8):
                    wr, (xe, xo) = words[8 * g + r], staged[8 * g + r]
                    isum = _dp4a(wr & _M4, xe, isum, False)
                    isum = _dp4a((wr >> 4) & _M4, xo, isum, False)
                isum = isum - 8 * xsum[g]
                assert torch.equal(isum, want[g])
                acc = acc + isum.float() * s[g].float()
            total = acc if total is None else total + acc
        out = out + total * sx[0]
    return out[None]


# The PTX layout of mma.m16n8k32's s8 fragments for lane (gid, t): A register
# q's byte e at row gid + 8 (q % 2), k 4 t + e + 16 (q // 2); B register p's
# byte e at k 4 t + e + 16 p, column gid; C/D element i at row gid + 8 (i //
# 2), column 2 t + i % 2.
_FGID, _FT = torch.meshgrid(torch.arange(8), torch.arange(4), indexing="ij")
_FQ, _FE = torch.arange(4)[:, None], torch.arange(4)[None, :]
_A_ROW = (_FGID[..., None, None] + 8 * (_FQ % 2)).expand(8, 4, 4, 4)
_A_K = 4 * _FT[..., None, None] + _FE + 16 * (_FQ // 2)
_B_K = 4 * _FT[..., None, None] + _FE + 16 * torch.arange(2)[:, None]
_B_COL = _FGID[..., None, None].expand(8, 4, 2, 4)
_C_ROW = _FGID[..., None] + 8 * (torch.arange(4) // 2)
_C_COL = 2 * _FT[..., None] + torch.arange(4) % 2


def _mma_s8(a, b, c):
    """mma.sync.m16n8k32.s32.s8.s8.s32 on the fragments of a warp: a (...,
    8, 4, 4) words [gid, t, q], b (..., 8, 4, 2), c (..., 8, 4, 4) int ->
    d (..., 8, 4, 4).  The products are exact in float64."""
    am = torch.zeros(*a.shape[:-3], 16, 32, dtype=torch.float64)
    am[..., _A_ROW, _A_K] = _signed(_bytes_of(a)).double()
    bm = torch.zeros(*b.shape[:-3], 32, 8, dtype=torch.float64)
    bm[..., _B_K, _B_COL] = _signed(_bytes_of(b)).double()
    cm = torch.zeros(*c.shape[:-3], 16, 8, dtype=torch.float64)
    cm[..., _C_ROW, _C_COL] = c.double()
    return (cm + am @ bm)[..., _C_ROW, _C_COL].long()


def test_mma_s8_fragment_maps_are_one_to_one():
    """Each of a warp's A (16 x 32), B (32 x 8) and C (16 x 8) slots is held
    by exactly one (lane, register, byte)."""
    for rows, cols, shape in ((_A_ROW, _A_K, (16, 32)), (_B_K, _B_COL, (32, 8)), (_C_ROW, _C_COL, (16, 8))):
        seen = torch.zeros(shape, dtype=torch.int64)
        seen.index_put_((rows.flatten(), cols.flatten()), torch.ones(rows.numel(), dtype=torch.int64),
                        accumulate=True)
        assert (seen == 1).all()


def _less8(lv):
    """The kernel's ``less8``: levels a byte to signed bytes q - 8, with bit 7
    set against borrows, then flipped."""
    return (((lv | 0x80808080) - 0x08080808) ^ 0x80808080) & 0xFFFFFFFF


def _e1_route_b_model(x8, sx, qw, s):
    """E1's route B: 128-column tiles of BM rows, the plan's K splits.  Per
    group, lane (gid, t) of warp w reads word rows 2 t + h of its columns 32
    w + 4 gid + j (b0 / b1: their low / high nibbles as signed q - 8), bytes
    16 t .. + 15 of x8 rows gid and gid + 8 (a: their even and odd rows by
    byte permutes) and starts its int32 fragment at 1.5 * 2^23's bits; two
    m16n8k32 k-steps, the fragment read as f32 less 1.5 * 2^23, held exactly
    to the plain version's group sums; scaled
    into f32 sums in group order, times sx, each split's sums equal to the
    plain version over the split's groups bit for bit, then added in split
    order.  Rows past M are zero and never stored."""
    m, k = x8.shape
    n, groups = qw.shape[1], k // GROUP
    assert TE1.route(m) == "b"
    bm = 16 if m <= 16 else 32 if m <= 32 else 64
    mtiles, tiles = -(-m // bm) * bm // 16, -(-n // 128)
    splits, per = TE1.plan(m, k, n)
    xp = torch.zeros((mtiles * 16, k), dtype=torch.int8)
    xp[:m] = x8
    # A side, per (m-tile, group): words [gid, t, i] of rows gid and gid + 8
    xw = _x8_words(xp).reshape(mtiles, 16, groups, 16).permute(0, 2, 1, 3)
    u, v = (xw[:, :, h * 8:(h + 1) * 8].reshape(mtiles, groups, 8, 4, 4) for h in range(2))
    c0 = torch.full((mtiles, groups, 8, 4, 4), _MAGIC_BITS, dtype=torch.int64)
    a = [torch.stack([_byte_perm(u[..., 2 * h], u[..., 2 * h + 1], 0x6420),
                      _byte_perm(v[..., 2 * h], v[..., 2 * h + 1], 0x6420),
                      _byte_perm(u[..., 2 * h], u[..., 2 * h + 1], 0x7531),
                      _byte_perm(v[..., 2 * h], v[..., 2 * h + 1], 0x7531)], -1) for h in range(2)]
    # B side, per (tile, warp, n-tile j, group): word [g, 2 t + h, column 32 w + 4 gid + j]
    words = torch.zeros((k // 8, tiles * 128), dtype=torch.int64)
    words[:, :n] = qw.to(torch.int64) & 0xFFFFFFFF
    wt = words.reshape(groups, 4, 2, tiles, 4, 8, 4).permute(3, 4, 6, 0, 2, 5, 1)  # [T, w, j, g, h, gid, t]
    b = [torch.stack([_less8(wt[:, :, :, :, h] & _M4), _less8((wt[:, :, :, :, h] >> 4) & _M4)], -1)
         for h in range(2)]
    lead_a = (mtiles, 1, 1, 1, groups)
    d = _mma_s8(a[0].view(*lead_a, 8, 4, 4), b[0], c0.view(*lead_a, 8, 4, 4))
    d = _mma_s8(a[1].view(*lead_a, 8, 4, 4), b[1], d)  # [mt, T, w, j, g, gid, t, i]
    isum_f = d.to(torch.int32).view(torch.float32) - 12582912.0
    # where each fragment element lands: D column 2 t + i % 2 is B column gid' =
    # 2 t + i % 2, i.e. output column 32 w + 4 gid' + j: the kernel's 32 w + 8 t + 4 c + j
    mt_, tile_, w_, j_, gid_, t_, i_ = torch.meshgrid(*(torch.arange(v) for v in (mtiles, tiles, 4, 4, 8, 4, 4)),
                                                      indexing="ij")
    row = 16 * mt_ + gid_ + 8 * (i_ // 2)
    col = 128 * tile_ + 32 * w_ + 4 * (2 * t_ + i_ % 2) + j_
    assert torch.equal(col, 128 * tile_ + 32 * w_ + 8 * t_ + 4 * (i_ % 2) + j_)
    flat = (row * tiles * 128 + col).flatten()
    assert torch.equal(torch.bincount(flat, minlength=mtiles * 16 * tiles * 128), torch.ones(mtiles * 16 * tiles * 128, dtype=torch.int64))
    by_g = d.permute(4, 0, 1, 2, 3, 5, 6, 7).reshape(groups, -1)  # [g, (mt, T, w, j, gid, t, i)]
    isum = torch.zeros((groups, mtiles * 16 * tiles * 128), dtype=torch.int64)
    isum[:, flat] = by_g - _MAGIC_BITS
    isum = isum.reshape(groups, mtiles * 16, tiles * 128)
    assert torch.equal(isum[:, :m, :n], _e1_group_sums(x8, qw))
    isum_f_out = torch.zeros((groups, mtiles * 16 * tiles * 128))
    isum_f_out[:, flat] = isum_f.permute(4, 0, 1, 2, 3, 5, 6, 7).reshape(groups, -1)
    isum_f_out = isum_f_out.reshape(groups, mtiles * 16, tiles * 128)[:, :m, :n]
    assert torch.equal(isum_f_out, isum[:, :m, :n].float())
    total = torch.zeros((m, n))
    for sp in range(splits):
        g0, g1 = sp * per, min(groups, (sp + 1) * per)
        acc = torch.zeros((m, n))
        for g in range(g0, g1):
            acc = acc + isum_f_out[g] * s[g].float()
        part = acc * sx[:, None]
        ks = slice(g0 * GROUP, g1 * GROUP)
        want = TE1.w4a8_matmul_plain(x8[:, ks], sx, qw[g0 * 8:g1 * 8], s[g0:g1])
        assert torch.equal(part, want)
        total = total + part
    return total


def _e1_inputs(seed, m, k, n):
    """Random levels over 0..15, bf16 scales, and x through E1's prologue
    (rows of absmax 127, so every x8 level from -127 to 127 can occur)."""
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.integers(0, 16, (k, n), dtype=np.uint8))
    s = torch.from_numpy(0.01 * rng.standard_normal((k // GROUP, n)).astype(np.float32)).to(torch.bfloat16)
    x8, sx = TE1.quantize_activations(_bf16_x(seed, m, k))
    return x8, sx, TW.pack_int4(q), s


@pytest.mark.parametrize("shape", list(K1_MODEL_SHAPES))
def test_e1_route_a_model_matches_plain(shape):
    """E1's route A (M = 1): the staged K order and the zero point taken out
    give each group's exact integer sum, and the warps' and splits' f32 sums
    equal the plain version in f32, at a ragged N and at 128 groups."""
    k, n = K1_MODEL_SHAPES[shape]
    x8, sx, qw, s = _e1_inputs(len(shape), 1, k, n)
    assert int(x8.abs().max()) == 127
    out = _e1_route_a_model(x8, sx, qw, s)
    np.testing.assert_allclose(out.numpy(), TE1.w4a8_matmul_plain(x8, sx, qw, s).numpy(), **MODEL_TOL)


@pytest.mark.parametrize("m", [2, 15, 17, 70, 256])
@pytest.mark.parametrize("shape", list(K1_MODEL_SHAPES))
def test_e1_route_b_model_matches_plain(shape, m):
    """E1's route B: the m16n8k32 fragments built as the kernel builds them
    give each group's exact integer sum at every (row, column), each split
    equals the plain version over its groups bit for bit, and the whole
    equals the plain version in f32, over row tiles of 16 (M = 2, 15), 32
    and 64 (two and four of them) at a ragged N and at 128 groups."""
    k, n = K1_MODEL_SHAPES[shape]
    x8, sx, qw, s = _e1_inputs(m + len(shape), m, k, n)
    out = _e1_route_b_model(x8, sx, qw, s)
    np.testing.assert_allclose(out.numpy(), TE1.w4a8_matmul_plain(x8, sx, qw, s).numpy(), **MODEL_TOL)
