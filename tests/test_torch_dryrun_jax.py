"""The JAX package's own sharded int4 decode at the port's dry-run shapes.

``parallel/dryrun.py`` holds the port's sharded decode to one rank's whole
model with the int4 cache, and reads the decode on each rank's own
quantized entries beside the JAX gate's bar (rtol 1e-4, atol 1e-5;
``__graft_entry__.py:dryrun_multichip``).  The port's own entries missed
that bar at 4 CPU ranks (5.5e-4 on the logits).  Here the JAX package runs
the same gate at the same shapes (the tiny preset at width 256, 8 heads, 2
layers, vocab 4096, a 2 x 2 mesh of the CPU devices ``tests/conftest.py``
makes, seed 0): its sharded prefill and decode write their own int4
entries, teacher-forced with the single device's greedy tokens.  It counts
the levels those entries take apart from the single device's, and how far
its logits land from the bar.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from phi_3_vision_mlx_tpu.core.config import preset  # noqa: E402
from phi_3_vision_mlx_tpu.models import phi3  # noqa: E402
from phi_3_vision_mlx_tpu.parallel.mesh import make_mesh  # noqa: E402
from phi_3_vision_mlx_tpu.parallel.sharding import shard_params, state_shardings  # noqa: E402

STEPS = 4


def _decode(params, cfg, ids, constraint, forced):
    """The JAX gate's ``_decode_logits``, returning the final state too."""

    @jax.jit
    def prefill(params, ids):
        res = phi3.prefill(params, cfg, ids, max_tokens=16)
        st = res.state if constraint is None else jax.lax.with_sharding_constraint(res.state, constraint)
        return res.logits[:, -1, :], st

    @jax.jit
    def step(params, tok, st):
        res = phi3.decode_forward(params, cfg, st, input_ids=tok)
        return res.logits[:, -1, :], res.state

    lg, st = prefill(params, ids)
    seq = [np.asarray(lg, np.float32)]
    for t in range(STEPS):
        tok = (jnp.asarray([[forced[t]]], jnp.int32) if forced is not None
               else jnp.argmax(lg, axis=-1).astype(jnp.int32)[:, None])
        lg, st = step(params, tok, st)
        seq.append(np.asarray(lg, np.float32))
    return seq, st


@pytest.fixture(scope="module")
def jax_runs():
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 JAX CPU devices (tests/conftest.py makes 8)")
    cfg = preset("tiny", hidden_size=256, intermediate_size=512, num_attention_heads=8, num_key_value_heads=8,
                 num_hidden_layers=2, vocab_size=4096, use_quantized_cache=True)
    mesh = make_mesh(data=2, model=2)
    params = phi3.init_params(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    b, l = 4, 32  # the dry run's batch: 2 x data rows of 32 tokens, drawn after the training batch
    rng.integers(2, 4000, (b, l))
    rng.integers(2, 4000, (b, l - 1))
    ids = jnp.asarray(rng.integers(2, 4000, (b, l)).astype(np.int32))
    single_params = jax.device_put(jax.tree_util.tree_map(np.asarray, params), jax.devices()[0])
    single, st1 = _decode(single_params, cfg, ids[:1], None, None)
    forced = [int(np.argmax(lg[0])) for lg in single[:-1]]
    sharded, st4 = _decode(shard_params(params, mesh), cfg, ids[:1], state_shardings(cfg, mesh), forced)
    return single, sharded, st1, st4


def test_jax_sharded_int4_decode_on_its_own_entries_meets_its_bar(jax_runs):
    """The JAX package's sharded run quantizes entries of its own: at these
    shapes none lands a level from the single device's, and its logits meet
    the bar its gate holds them to.  So the port's dry run holds its own
    entries to the same bar (``parallel/dryrun.py`` raises where they miss
    it; ``tests/test_torch_parallel.py:test_dryrun_multichip_cpu``)."""
    single, sharded, st1, st4 = jax_runs
    p1, p4 = np.asarray(st1.kv.k), np.asarray(st4.kv.k)
    written = int(np.asarray(st1.offset).max()) if np.ndim(st1.offset) else int(st1.offset)
    lv1 = np.stack([p1 & 15, p1 >> 4])[..., :written].astype(np.int32)
    lv4 = np.stack([p4 & 15, p4 >> 4])[..., :written].astype(np.int32)
    flips = int((lv1 != lv4).sum())
    step = int(np.abs(lv1 - lv4).max())
    diff = max(float(np.abs(a - b).max()) for a, b in zip(single, sharded))
    met = all(np.allclose(a, b, rtol=1e-4, atol=1e-5) for a, b in zip(single, sharded))
    print(f"JAX sharded int4 decode at width 256, 2 x 2 mesh: {flips} of {lv1.size} levels apart (max step "
          f"{step}), max |logit diff| {diff:.3g}, the bar {'met' if met else 'not met'}")
    assert (flips, step, met) == JAX_READING, (flips, step, diff, met)
    assert diff < 1e-5


# (levels apart, largest step, bar met), measured: 0 of 18432 levels, 2.9e-6
# on the logits.
JAX_READING = (0, 0, True)
