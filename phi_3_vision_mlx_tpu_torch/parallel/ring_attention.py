"""Ring attention: context parallelism over a mesh axis (counterpart of
``phi_3_vision_mlx_tpu/parallel/ring_attention.py``).

The sequence is cut over the ranks of one mesh axis; each rank keeps
online-softmax statistics for its own queries while the K and V blocks (and
their ``valid`` bits) travel round the ring, rank ``i`` sending to ``i +
1``, through ``dist.batch_isend_irecv``.  After P - 1 hops every query has
seen every key, and the bytes sent total one all-gather's.  The next hop is
posted before a block's attention and waited for after it, so the transfer
overlaps the compute; the JAX package also permutes after the last block
(its scan body is one traced program), which this loop skips.  A ring of
one sends nothing (NCCL cannot send to itself).

The block attention is plain PyTorch, as the JAX package's is an einsum
outside any Pallas kernel (``ring_attention.py:26-36``): f32 scores of the
(B, H, L/P, L/P) block, so a 4224-token prompt on one rank holds about 2.2
GiB of scores a layer (32 heads; their exponentials are taken in place),
while that layer runs.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def _block_attend(q, k, v, allowed, scale: float):
    """One partial-attention block: (exp-scores @ v, row max, row sum)."""
    s = torch.matmul((q * scale).float(), k.float().transpose(-1, -2))
    s.masked_fill_(~allowed, NEG_INF)
    m = s.amax(dim=-1)  # (B, H, Lq)
    p = s.sub_(m[..., None]).exp_()  # in place: one (B, H, Lq, Lk) f32 buffer
    l = p.sum(dim=-1)
    o = torch.matmul(p.to(v.dtype), v).float()
    return o, m, l


def ring_self_attention(q, k, v, valid, scale: float, group):
    """Causal self-attention with the sequence cut over the ranks of
    ``group``: q (B, H, Lq, D), k and v (B, KV, Lq, D) and ``valid`` (B,
    Lq) bool are this rank's shard, and rank i of the group holds the
    global positions ``[i Lq, (i + 1) Lq)``.  A query sees the keys at or
    before its position that are ``valid``; GQA heads are repeated for each
    block.  The merge runs in f32 with ``NEG_INF`` for masked scores, so a
    query that sees no key averages all of them, as in the JAX package.
    Returns this rank's output (B, H, Lq, D) in q's dtype."""
    p = dist.get_world_size(group)
    my = dist.get_rank(group)
    ranks = dist.get_process_group_ranks(group)
    b, h, lq, d = q.shape
    rep = h // k.shape[1]
    dev = q.device
    q_pos = my * lq + torch.arange(lq, device=dev)
    m_run = torch.full((b, h, lq), NEG_INF, dtype=torch.float32, device=dev)
    l_run = torch.zeros((b, h, lq), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, h, lq, d), dtype=torch.float32, device=dev)
    blk = (k.contiguous(), v.contiguous(), valid.to(torch.uint8).contiguous())
    for step in range(p):
        pending = None
        if step + 1 < p:
            nxt = tuple(torch.empty_like(t) for t in blk)
            ops = [dist.P2POp(dist.isend, t, ranks[(my + 1) % p], group) for t in blk]
            ops += [dist.P2POp(dist.irecv, t, ranks[(my - 1) % p], group) for t in nxt]
            pending = dist.batch_isend_irecv(ops)
        k_blk, v_blk, valid_blk = blk
        src = (my - step) % p
        key_pos = src * lq + torch.arange(lq, device=dev)
        allowed = (key_pos[None, :] <= q_pos[:, None])[None, None] & valid_blk.bool()[:, None, None, :]
        if rep > 1:
            k_blk, v_blk = k_blk.repeat_interleave(rep, dim=1), v_blk.repeat_interleave(rep, dim=1)
        o_blk, m_blk, l_blk = _block_attend(q, k_blk, v_blk, allowed, scale)
        m_new = torch.maximum(m_run, m_blk)
        alpha = torch.exp(m_run - m_new)
        beta = torch.exp(m_blk - m_new)
        l_run = alpha * l_run + beta * l_blk
        acc = acc * alpha[..., None] + o_blk * beta[..., None]
        m_run = m_new
        if pending is not None:
            for req in pending:
                req.wait()
            blk = nxt
    l_run = torch.where(l_run == 0.0, 1.0, l_run)
    return (acc / l_run[..., None]).to(q.dtype)


def make_ring_attention(mesh, seq_axis: str = "data"):
    """Ring attention over ``seq_axis`` of ``mesh``: ``fn(q, k, v, valid)``
    on this rank's shards (``shard_map``'s view in the JAX package, whose
    function takes the whole arrays), with the scale ``D ** -0.5``."""
    group = mesh.get_group(seq_axis)

    def fn(q, k, v, valid):
        return ring_self_attention(q, k, v, valid, q.shape[-1] ** -0.5, group)

    return fn
