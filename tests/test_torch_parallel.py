"""The port's parallel layer (``phi_3_vision_mlx_tpu_torch/parallel``) on the
CPU against the JAX package: the sharding specs rule for rule, meshes, each
rank's shards, and the tensor-parallel model in a spawned gloo world of
four ranks (data 2 x model 2): the sharded prefill, the teacher-forced
sharded decode with the dense and the int4 cache, and one dp+tp LoRA step.

The weights are drawn with numpy from a seed (``torch_world.numpy_params``)
and carried into both packages.  JAX computes its references on one
device (GSPMD gives the function of the unsharded model, as its own
``tests/test_parallel.py`` holds).  The int4 decode replays the JAX cache's
entries for each rank's heads (``parallel/dryrun.py:ReplayEntries``): a
1-ulp difference in k or v can round to the neighbouring level.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from phi_3_vision_mlx_tpu.core.config import preset as jax_preset  # noqa: E402
from phi_3_vision_mlx_tpu.models import phi3 as JM  # noqa: E402
from phi_3_vision_mlx_tpu.parallel import sharding as JS  # noqa: E402
from phi_3_vision_mlx_tpu.parallel.mesh import make_mesh as jax_make_mesh  # noqa: E402
from phi_3_vision_mlx_tpu.train import lora as JL  # noqa: E402
from phi_3_vision_mlx_tpu_torch.core import weights as TW  # noqa: E402
from phi_3_vision_mlx_tpu_torch.core.config import QuantConfig, preset  # noqa: E402
from phi_3_vision_mlx_tpu_torch.core.convert import from_jax_kv_cache, from_numpy_params  # noqa: E402
from phi_3_vision_mlx_tpu_torch.models import phi3 as TM  # noqa: E402
from phi_3_vision_mlx_tpu_torch.parallel import mesh as PM  # noqa: E402
from phi_3_vision_mlx_tpu_torch.parallel import sharding as PS  # noqa: E402
from phi_3_vision_mlx_tpu_torch.parallel.dryrun import dryrun_multichip  # noqa: E402
from phi_3_vision_mlx_tpu_torch.parallel.tensor import TensorParallel  # noqa: E402
from phi_3_vision_mlx_tpu_torch.train.lora import inject_lora  # noqa: E402
from test_torch_model import one_thread  # noqa: E402,F401
from torch_world import lora_loss_and_grads, lora_tree, numpy_params, parallel_suite  # noqa: E402

SIZES = dict(hidden_size=256, intermediate_size=512, num_attention_heads=8, num_key_value_heads=8,
             vocab_size=4096)
CFG = preset("tiny", **SIZES)  # tests/test_parallel.py's model, fp32
JCFG = jax_preset("tiny", **SIZES)
PREFILL_TOL = 5e-4  # the bar of tests/test_parallel.py:33 (rtol and atol)
# fp32 logits of O(1-10) from two packages whose sums go in another order
# (tests/test_torch_model.py:FP32_ATOL); the sharded run adds the
# all-reduces' order.
DECODE_ATOL = 1e-4
LOSS_RTOL = 1e-5
FORCED_STEPS = 4


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}.{k}" if path else k)
    else:
        yield path, tree


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _train_batch():
    """The inputs of tests/test_multihost.py:train_step_loss."""
    rng = np.random.default_rng(0)
    b, l = 8, 32
    return {
        "ids": rng.integers(2, 4000, (b, l)).astype(np.int32),
        "pids": np.tile(np.arange(l, dtype=np.int32), (b, 1)),
        "valid": np.ones((b, l), bool),
        "targets": rng.integers(2, 4000, (b, l - 1)).astype(np.int32),
        "loss_masks": np.ones((b, l - 1), np.float32),
    }


def _jax_lora_step(tree, batch):
    """JAX's LoRA loss and gradients of the trainable leaves (one device),
    and its A."""
    import optax

    params, _ = JL.inject_lora(_jax(tree), JCFG, ["self_attn.qkv_proj"], 1, 2, jax.random.PRNGKey(1))
    trainable, frozen = JL.partition_lora(params)

    def loss_fn(trainable):
        logits = JM.forward_nocache(JL.merge_lora(frozen, trainable), JCFG, batch["ids"], pids=batch["pids"],
                                    prompt_valid=batch["valid"]).astype(jnp.float32)
        ce = optax.softmax_cross_entropy_with_integer_labels(logits[:, :-1], batch["targets"])
        return (ce * batch["loss_masks"]).mean()

    loss, grads = jax.value_and_grad(loss_fn)(trainable)
    node = trainable["model"]["layers"]["self_attn"]["qkv_proj"]
    g = grads["model"]["layers"]["self_attn"]["qkv_proj"]
    return float(loss), {k: np.asarray(v) for k, v in g.items()}, np.asarray(node["lora_a"])


def _jax_decode(tree, cfg, ids):
    """JAX prefill and FORCED_STEPS greedy steps: each forward's logits, the
    greedy tokens and the final state."""
    params = _jax(tree)
    res = JM.prefill(params, cfg, jnp.asarray(ids), max_tokens=16)
    logits, state, tokens = [np.asarray(res.logits)], res.state, []
    for _ in range(FORCED_STEPS):
        tokens.append(int(np.asarray(res.logits[0, -1]).argmax()))
        res = JM.decode_forward(params, cfg, state, jnp.asarray([[tokens[-1]]], jnp.int32))
        logits.append(np.asarray(res.logits))
        state = res.state
    return logits, tokens, state


@pytest.fixture(scope="module")
def world():
    """One spawned world of four ranks, every check's rank outputs, beside
    the JAX references."""
    tree = numpy_params(CFG, seed=0)
    rng = np.random.default_rng(1)
    prefill_ids = rng.integers(2, 4000, (2, 16))
    decode_ids = rng.integers(2, 4000, (1, 32))
    jax_prefill = np.asarray(JM.prefill(_jax(tree), JCFG, jnp.asarray(prefill_ids), max_tokens=4).logits)
    dense = _jax_decode(tree, JCFG, decode_ids)
    int4 = _jax_decode(tree, JCFG.replace(use_quantized_cache=True), decode_ids)
    kv = int4[2].kv
    entries = from_jax_kv_cache(np.asarray(kv.k), np.asarray(kv.k_scales.astype(jnp.float32)),
                                JCFG.kv_quant.bits)
    batch = _train_batch()
    jax_loss, jax_grads, lora_a = _jax_lora_step(tree, batch)
    ranks = PM.run_world(parallel_suite, 4, tree, CFG, prefill_ids, decode_ids, (dense[1], int4[1]), entries,
                         (lora_a, batch), timeout=240.0)
    return dict(tree=tree, prefill_ids=prefill_ids, jax_prefill=jax_prefill, dense=dense, int4=int4,
                batch=batch, jax_loss=jax_loss, jax_grads=jax_grads, lora_a=lora_a, ranks=ranks)


# -- specs --------------------------------------------------------------------


def _jax_trees():
    tiny = JM.init_params(JCFG, jax.random.PRNGKey(0))
    lora, _ = JL.inject_lora(tiny, JCFG, ["self_attn.qkv_proj", "self_attn.o_proj", "mlp.gate_up_proj",
                                          "mlp.down_proj"], 1, 2, jax.random.PRNGKey(1))
    vision = jax.eval_shape(lambda k: JM.init_params(jax_preset("tiny_vision"), k), jax.random.PRNGKey(0))
    return {"tiny": tiny, "lora": lora, "tiny_vision": vision}


@pytest.mark.parametrize("name", ["tiny", "lora", "tiny_vision"])
def test_spec_for_param_matches_jax(name):
    """The port's rules give the JAX ``PartitionSpec`` on every path of the
    tree (a spec is a tuple in both)."""
    leaves = list(_leaves(_jax_trees()[name]))
    assert len(leaves) > 10
    for path, leaf in leaves:
        assert PS._spec_for_param(path, leaf.ndim) == tuple(JS._spec_for_param(path, leaf.ndim)), path


def _port_trees():
    """The port's leaf kinds: full, word 4-bit and 8-bit, packed, LoRA."""
    full = TM.init_params(CFG, torch.Generator().manual_seed(0))
    out = {"full": full}
    for bits in (4, 8):
        cfg = CFG.replace(quantized=QuantConfig(group_size=64, bits=bits, mode="affine"))
        out[f"w{bits}"] = TW.synth_quantized_params(cfg, device="cpu", seed=0)
    cfg4 = CFG.replace(quantized=QuantConfig(group_size=64, bits=4, mode="affine"))
    out["packed"] = TW.packed_params(out["w4"], cfg4)
    out["lora"], _ = inject_lora(TM.init_params(CFG, torch.Generator().manual_seed(0)), CFG,
                                 ["self_attn.qkv_proj", "self_attn.o_proj"], 1, 2, torch.Generator().manual_seed(1))
    return out, cfg4


@pytest.fixture(scope="module")
def port_trees():
    return _port_trees()


def test_param_shardings_cover_the_port_leaves(port_trees):
    """``param_shardings`` gives each of the port's leaves (``qweight``,
    packed ``weight``, LoRA) the JAX rule's spec of its path."""
    trees, _ = port_trees
    for name, tree in trees.items():
        specs = dict(_leaves(PS.param_shardings(tree), ""))
        leaves = dict(_leaves(tree))
        assert specs.keys() == leaves.keys()
        for path, leaf in leaves.items():
            assert specs[path] == tuple(JS._spec_for_param(path, leaf.ndim)), (name, path)
    assert dict(_leaves(PS.param_shardings(trees["w4"])))["model.layers.self_attn.qkv_proj.qweight"] == (
        None, None, "model")
    assert dict(_leaves(PS.param_shardings(trees["w4"])))["model.layers.mlp.down_proj.scales"] == (
        None, "model", None)


def test_state_shardings_match_jax():
    """The decode state's specs: the cache's heads on model, batch on data."""
    mesh = jax_make_mesh(data=2, model=4)
    for quantized in (False, True):
        want = JS.state_shardings(JCFG.replace(use_quantized_cache=quantized), mesh)
        got = PS.state_shardings(CFG.replace(use_quantized_cache=quantized))
        assert got["k"] == tuple(want.kv.k.spec)
        assert got["valid"] == tuple(want.valid.spec)
        assert got["cos"] == tuple(want.cos.spec)
        if quantized:
            assert got["k_scales"] == tuple(want.kv.k_scales.spec) and got["v"] is None
        else:
            assert got["v"] == tuple(want.kv.v.spec)


# -- meshes -------------------------------------------------------------------


@pytest.fixture
def world_of_one():
    PM.distributed_init(device="cpu")
    yield
    torch.distributed.destroy_process_group()


def test_make_mesh_raises_on_too_small_a_world(world_of_one):
    with pytest.raises(ValueError, match="need 2 devices, have 1"):
        PM.make_mesh(data=2)
    with pytest.raises(ValueError, match="need 8 devices, have 1"):
        PM.make_mesh(dcn=2, data=2, model=2)
    mesh = PM.single_device_mesh()
    assert mesh.mesh_dim_names == ("data", "model") and PM.batch_axes(mesh) == ("data",)
    assert PM.axis_size(mesh, "model") == 1 and mesh.get_local_rank("data") == 0


def test_distributed_init_names_its_backend():
    """``"cuda"`` means NCCL on a card, never a fall-back to gloo; this
    machine has neither."""
    with pytest.raises(RuntimeError, match="NCCL and a CUDA device"):
        PM.distributed_init(device="cuda")
    with pytest.raises(ValueError, match="together"):
        PM.distributed_init("localhost:1234", device="cpu")
    assert not torch.distributed.is_initialized()


def test_tp_hooks_at_one_rank_are_bitwise_the_plain_path(world_of_one):
    """At one rank every collective is an identity: prefill and 8 decode
    steps through the hooks give the plain path's bits (the card's phase 16
    (c)), dense and int4."""
    mesh = PM.make_mesh(1, 1)
    params = PS.shard_params(TM.init_params(CFG, torch.Generator().manual_seed(0)), mesh)
    ids = torch.as_tensor(np.random.default_rng(2).integers(2, 4000, (1, 24)))
    for quantized in (False, True):
        cfg = PS.local_config(CFG.replace(use_quantized_cache=quantized), 1)
        tp = TensorParallel.of(mesh)
        with torch.no_grad():
            runs = []
            for hooks in (None, tp):
                res = TM.prefill(params, cfg, ids, max_tokens=8, tp=hooks)
                logits, state = [res.logits], res.state
                for _ in range(8):
                    res = TM.decode_forward(params, cfg, state, res.logits[:, -1:].argmax(-1), tp=hooks)
                    logits.append(res.logits)
                    state = res.state
                runs.append(logits)
        assert all(torch.equal(a, b) for a, b in zip(*runs))
        assert tp.collectives == 9 * (2 + 2 * CFG.num_hidden_layers)  # embed, 2 a layer, lm_head


class _Mesh:
    """A stand-in for a mesh's coordinates (the batch-shard arithmetic)."""

    def __init__(self, names, sizes, coords):
        self.mesh_dim_names, self._sizes, self._coords = names, sizes, coords
        self.device_type = "cpu"

    def size(self, i):
        return self._sizes[i]

    def get_local_rank(self, name):
        return self._coords[self.mesh_dim_names.index(name)]


def test_shard_batch_cuts_over_dcn_and_data_jointly():
    batch = {"ids": np.arange(8 * 3).reshape(8, 3)}
    seen = []
    for dcn in range(2):
        for data in range(2):
            mesh = _Mesh(("dcn", "data", "model"), (2, 2, 2), (dcn, data, 1))
            assert PM.batch_axes(mesh) == ("dcn", "data")
            seen.append(PS.shard_batch(batch, mesh)["ids"])
    assert torch.equal(torch.cat(seen), torch.as_tensor(batch["ids"]))
    with pytest.raises(ValueError, match="does not split"):
        PS.shard_batch({"ids": np.zeros((3, 2))}, _Mesh(("data", "model"), (2, 1), (0, 0)))


# -- shards -------------------------------------------------------------------


def dense_weight(node, group: int = 64):
    """A linear leaf's (..., K, N) weight in f32, whatever its layout."""
    if "qweight" not in node and not TW.is_packed_leaf(node):
        return node["weight"].float()
    k = node["scales"].shape[-2] * group
    if "qweight" in node:
        q = TW.LAYOUTS[TW.leaf_bits(node["qweight"], k)][2](node["qweight"])
    else:
        q = TW.from_packed_layout(node["weight"], group)
    return (q.float() * node["scales"].float().repeat_interleave(group, dim=-2)
            + node["biases"].float().repeat_interleave(group, dim=-2))


def _segments(t, widths, tp, dim=-1):
    """Each segment's rank shares: [[seg0_r0, seg0_r1, ...], ...]."""
    out, start = [], 0
    for w in widths:
        out.append(list(t.narrow(dim, start, w).chunk(tp, dim=dim)))
        start += w
    return out


@pytest.mark.parametrize("tp", [2, 4])
def test_fused_projections_shard_per_segment(port_trees, tp):
    """qkv and gate_up: a rank holds its heads' q, k and v (its share of
    gate and up), concatenated; o_proj and down_proj: its rows; embed and
    lm_head: its vocab rows and columns; LoRA's A whole (rows at o_proj)
    and B per segment.  In every layout the dequantized shards are the cut
    of the dequantized whole."""
    trees, cfg4 = port_trees
    e = CFG.hidden_size
    n_qkv = (CFG.num_attention_heads + 2 * CFG.num_key_value_heads) * CFG.head_dim
    for name in ("full", "w4", "w8", "packed", "lora"):
        whole = trees[name]
        layers = whole["model"]["layers"]

        for r in range(tp):
            local = PS.local_shards(whole, r, tp)
            ll = local["model"]["layers"]
            qkv = dense_weight(ll["self_attn"]["qkv_proj"])
            want = torch.cat([seg[r] for seg in _segments(dense_weight(layers["self_attn"]["qkv_proj"]),
                                                          (e, (n_qkv - e) // 2, (n_qkv - e) // 2), tp)], dim=-1)
            torch.testing.assert_close(qkv, want, rtol=0, atol=0)
            gu = dense_weight(ll["mlp"]["gate_up_proj"])
            want = torch.cat([seg[r] for seg in _segments(dense_weight(layers["mlp"]["gate_up_proj"]),
                                                          (CFG.intermediate_size,) * 2, tp)], dim=-1)
            torch.testing.assert_close(gu, want, rtol=0, atol=0)
            for path in (("self_attn", "o_proj"), ("mlp", "down_proj")):
                got = dense_weight(ll[path[0]][path[1]])
                torch.testing.assert_close(got, dense_weight(layers[path[0]][path[1]]).chunk(tp, dim=-2)[r],
                                           rtol=0, atol=0)
            emb = local["model"]["embed_tokens"]["weight"]
            assert torch.equal(emb, whole["model"]["embed_tokens"]["weight"].chunk(tp, dim=0)[r])
            head = dense_weight(local["lm_head"])
            assert torch.equal(head, dense_weight(whole["lm_head"]).chunk(tp, dim=-1)[r])
            assert local["model"]["norm"]["weight"] is whole["model"]["norm"]["weight"]
            if name == "lora":
                qn, on = ll["self_attn"]["qkv_proj"], ll["self_attn"]["o_proj"]
                assert qn["lora_a"] is layers["self_attn"]["qkv_proj"]["lora_a"]
                assert qn["lora_b"].shape[-1] == n_qkv // tp
                assert torch.equal(on["lora_a"], layers["self_attn"]["o_proj"]["lora_a"].chunk(tp, dim=-2)[r])
                assert on["lora_b"] is layers["self_attn"]["o_proj"]["lora_b"]
        assert PS.local_shards(whole, 0, 1) is whole


def test_row_split_must_keep_whole_groups(port_trees):
    """K/tp of a quantized row-parallel linear is a multiple of the group."""
    trees, _ = port_trees
    with pytest.raises(ValueError, match="does not split"):
        PS.local_shards(trees["w4"], 0, 8)  # o_proj K = 256: 32 rows a rank, half a group


def test_local_config_keeps_the_head_size():
    cfg = PS.local_config(CFG, 4)
    assert (cfg.num_attention_heads, cfg.num_key_value_heads, cfg.intermediate_size) == (2, 2, 128)
    assert cfg.head_dim == CFG.head_dim and cfg.hidden_size == CFG.hidden_size
    assert cfg.replace(use_quantized_cache=True).head_dim == CFG.head_dim
    assert PS.local_config(CFG, 1) is CFG
    with pytest.raises(ValueError, match="do not split"):
        PS.local_config(CFG, 3)


# -- the tensor-parallel model in a world of four -------------------------------


def test_sharded_prefill_matches_jax(world):
    """(data 2, model 2): each data rank prefills its row of the batch
    through the tensor-parallel hooks; the logits (gathered over model) are
    JAX's within the tests/test_parallel.py bar."""
    for rank, out in enumerate(world["ranks"]):
        d, _ = out["coords"]
        np.testing.assert_allclose(out["prefill"], world["jax_prefill"][d : d + 1], rtol=PREFILL_TOL,
                                   atol=PREFILL_TOL)
        # the cache holds the rank's KV heads (cut on model) and batch row (on data)
        assert out["state_shapes"]["k"] == (CFG.num_hidden_layers, 1, CFG.num_key_value_heads // 2, 20,
                                            CFG.head_dim)
        assert out["collectives"] == 2 + 2 * CFG.num_hidden_layers


@pytest.mark.parametrize("cache", ["dense", "int4"])
def test_sharded_decode_matches_jax(world, cache):
    """The decode of one prompt, teacher-forced with JAX's greedy tokens,
    every forward's logits within DECODE_ATOL of JAX's; the int4 cache
    replays JAX's entries of each rank's heads, and its own entries differ
    by at most one level at a share below 1e-3."""
    jax_logits = world[cache][0]
    for out in world["ranks"]:
        got = out[f"decode_{cache}"]
        assert len(got) == FORCED_STEPS + 1
        for a, b in zip(got, jax_logits):
            np.testing.assert_allclose(a, b, rtol=0, atol=DECODE_ATOL)
        values, flips, max_step = out["replay"]
        assert values > 0 and max_step <= 1 and flips <= 1e-3 * values


def test_dp_tp_lora_step_matches_jax_and_one_process(world):
    """One LoRA step on the inputs of tests/test_multihost.py:train_step_loss:
    the loss over the batch on every rank equals the single-process port's
    and JAX's, and the gradients, each rank's B cut put back together, are
    JAX's."""
    batch = {k: torch.as_tensor(v) for k, v in world["batch"].items()}
    trainable, frozen = lora_tree(world["tree"], CFG, world["lora_a"])
    single_loss, single = lora_loss_and_grads(trainable, frozen, CFG, batch)
    np.testing.assert_allclose(single_loss, world["jax_loss"], rtol=LOSS_RTOL)
    ranks = world["ranks"]
    for out in ranks:
        np.testing.assert_allclose(out["loss"], single_loss, rtol=LOSS_RTOL)
    e = CFG.hidden_size
    n = (CFG.num_attention_heads + 2 * CFG.num_key_value_heads) * CFG.head_dim
    widths = (e, (n - e) // 2, (n - e) // 2)
    by_model = sorted((out["coords"][1], out["grads"]["model"]["layers"]["self_attn"]["qkv_proj"])
                      for out in ranks if out["coords"][0] == 0)
    pieces = [[torch.as_tensor(g["lora_b"]).narrow(-1, sum(widths[:s]) // 2, widths[s] // 2) for _, g in by_model]
              for s in range(3)]
    lora_b = torch.cat([torch.cat(p, dim=-1) for p in pieces], dim=-1).numpy()
    want = world["jax_grads"]
    scale = np.abs(want["lora_b"]).max()
    assert scale > 0
    np.testing.assert_allclose(lora_b, want["lora_b"], rtol=0, atol=1e-4 * scale)
    np.testing.assert_allclose(single["model"]["layers"]["self_attn"]["qkv_proj"]["lora_b"].numpy(),
                               want["lora_b"], rtol=0, atol=1e-4 * scale)
    for _, g in by_model:  # A's gradient, summed over model: whole and equal on the ranks
        np.testing.assert_allclose(g["lora_a"], want["lora_a"], rtol=0, atol=1e-6)


def test_dryrun_multichip_cpu(capsys):
    """The JAX OK line, after the reading of the int4 sharded decode on the
    ranks' own entries, which meets the JAX bar (the JAX package's own run
    does at these shapes: tests/test_torch_dryrun_jax.py), as the replayed
    run does."""
    line = dryrun_multichip(4, device="cpu")
    printed = capsys.readouterr().out.splitlines()
    assert printed[-1] == line and printed[-2].startswith(
        "dryrun_multichip int4 sharded decode on each rank's own entries: max |logit diff| ")
    assert "the JAX bar (rtol 1e-4, atol 1e-5) met" in printed[-2] and "a level apart" in printed[-2]
    assert line.startswith("dryrun_multichip OK: mesh=(2x2), train loss=")
    assert "decode logits=(4, 4096)" in line and "sharded-decode parity=True" in line
    assert "ring-attn out=(2, 8, 64, 32)" in line


def test_dryrun_multichip_cuda_needs_cards():
    with pytest.raises(RuntimeError, match="needs 1 CUDA devices"):
        dryrun_multichip(1, device="cuda")


@pytest.mark.slow
def test_dryrun_multichip_dcn_eight_ranks():
    """The (dcn, data, model) forward runs at 8 ranks (the JAX twin,
    tests/test_multihost.py, is slow too)."""
    line = dryrun_multichip(8, device="cpu")
    assert line.startswith("dryrun_multichip OK: mesh=(2x4)")


def test_port_has_a_counterpart_of_every_jax_module():
    """Every ``*.py`` of the JAX package has a file of the same path in the
    port (the parallel layer and RetNet were the last)."""
    import pathlib

    root = pathlib.Path(__file__).resolve().parents[1]

    def modules(pkg):
        return {str(p.relative_to(root / pkg)) for p in (root / pkg).rglob("*.py")}

    assert modules("phi_3_vision_mlx_tpu") <= modules("phi_3_vision_mlx_tpu_torch")


# Public names of the JAX package that the port leaves out by design, by
# module, each with its reason (``ClassName.method`` for a method).
_KERNEL_LAYOUTS = "a TPU layout or Pallas body: the port's kernels are CUDA in csrc/ behind its own wrappers"
LEFT_OUT = {
    "core/weights.py": {
        "download_and_convert": "needs the network, which neither machine has (api._setup writes random pairs)",
        "kernelize_params": "converts leaves to the TPU kernels' tiled layouts; the CUDA kernels read the "
                            "checkpoint's words (core/weights.py:prepare_params)",
    },
    "engine/batching.py": {
        "SlotState.tree": "pytree flattening for jax.jit; the port's state is plain tensors updated in place",
        "SlotState.from_tree": "pytree unflattening for jax.jit",
    },
    "engine/paging.py": {
        "PagedState.tree": "pytree flattening for jax.jit",
        "PagedState.from_tree": "pytree unflattening for jax.jit",
    },
    "engine/engine.py": {
        f"LM.{name}": "builds a jitted function; the port's steps are CUDA graphs (engine/graphs.py, "
                      "Decoder, SlotStep, StaticStep)"
        for name in ("chunk_fn", "prefill_fn", "extend_fn", "prefill_vision_fn", "prefill_vision_raw_fn",
                     "prefill_vision_rawimg_fn")
    },
    "engine/speculative.py": {
        "spec_chunk_fn": "builds the jitted speculative chunk; the port's verify pass is a graph (SpecPass)",
    },
    "engine/state.py": {
        "KVCache": "the JAX cache pytree; the port's DecodeState holds the stacked cache tensors",
        "LayerKV": "a per-layer view of the JAX pytree; the port indexes the stacked tensors",
        "index_layer": "slices the JAX pytree; the kernels read the stacked cache at a layer in place",
        "DecodeState.kv": "the JAX cache pytree as one field; the port's DecodeState holds the stacked k, v "
                          "(and the int4 cache's k_scales) as fields of their own",
    },
    "ops/linear.py": {
        "matmul_precision": "a jax.lax.Precision for XLA; torch runs fp32 matmuls in full f32 (TF32 off)",
    },
    "parallel/sharding.py": {
        "batch_spec": "a NamedSharding of jax.sharding; the port shards batches with shard_batch",
    },
    "train/checkpoint.py": {
        "make_manager": "an orbax CheckpointManager; the port saves its train state with torch.save",
    },
    "ops/kernels/flash_attention.py": {name: _KERNEL_LAYOUTS for name in ("NEG_INF", "LANES")},
    "ops/kernels/kv_attention.py": {name: _KERNEL_LAYOUTS for name in ("NEG_INF", "d_perm", "d_unperm")},
    "ops/kernels/quant_matmul.py": {
        name: _KERNEL_LAYOUTS
        for name in ("BLOCK_K", "PACK_BLOCK_N", "to_kernel_layout", "unpermute_payload", "permute_activation",
                     "pack_nibbles", "unpack_nibbles", "to_tiled_layout", "from_tiled_layout",
                     "quant_matmul_tiled", "quant_matmul_tiled_stacked", "quant_matmul_interleaved",
                     "quant_matmul_packed_stacked")
    },
}


def _public_names(path):
    """(module-level names a module defines, {class: its method and
    class-attribute names}) of a source file, by AST."""
    import ast

    tree = ast.parse(path.read_text())
    top, classes = set(), {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            top.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            for target in (node.targets if isinstance(node, ast.Assign) else [node.target]):
                top.update(n.id for n in ast.walk(target) if isinstance(n, ast.Name))
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            top.update((a.asname or a.name).split(".")[0] for a in node.names)
        if isinstance(node, ast.ClassDef):
            members = set()
            for item in node.body:
                if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    members.add(item.name)
                elif isinstance(item, (ast.Assign, ast.AnnAssign)):
                    for target in (item.targets if isinstance(item, ast.Assign) else [item.target]):
                        members.update(n.id for n in ast.walk(target) if isinstance(n, ast.Name))
            classes[node.name] = members
    return top, classes


def test_port_has_a_counterpart_of_every_public_jax_name():
    """Every public top-level name a JAX module defines (functions, classes,
    constants) and every public method of its classes has a name in the
    port's module of the same path, or stands in LEFT_OUT with its reason;
    nothing in LEFT_OUT has a counterpart after all."""
    import ast
    import pathlib

    root = pathlib.Path(__file__).resolve().parents[1]
    missing, stale = [], []
    for path in sorted((root / "phi_3_vision_mlx_tpu").rglob("*.py")):
        rel = str(path.relative_to(root / "phi_3_vision_mlx_tpu"))
        theirs = ast.parse(path.read_text()).body
        mine, my_classes = _public_names(root / "phi_3_vision_mlx_tpu_torch" / rel)
        _, their_classes = _public_names(path)
        defined = set()
        for node in theirs:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                defined.add(node.name)
            elif isinstance(node, (ast.Assign, ast.AnnAssign)):
                for target in (node.targets if isinstance(node, ast.Assign) else [node.target]):
                    defined.update(n.id for n in ast.walk(target) if isinstance(n, ast.Name))
        wanted = {n for n in defined if not n.startswith("_")}
        wanted |= {f"{c}.{m}" for c, ms in their_classes.items() if not c.startswith("_") and c in my_classes
                   for m in ms if not m.startswith("_")}
        left_out = LEFT_OUT.get(rel, {})
        for name in sorted(wanted):
            cls, _, method = name.partition(".")
            present = method in my_classes.get(cls, set()) if method else name in mine
            if not present and name not in left_out:
                missing.append(f"{rel}:{name}")
            if present and name in left_out:
                stale.append(f"{rel}:{name}")
        stale += [f"{rel}:{name}" for name in left_out if name not in wanted]
    assert not missing, f"JAX names without a counterpart in the port: {missing}"
    assert not stale, f"LEFT_OUT names that the port has, or the JAX package lacks: {stale}"
    assert all(reason for names in LEFT_OUT.values() for reason in names.values())
