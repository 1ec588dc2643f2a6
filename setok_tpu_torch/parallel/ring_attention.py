"""Ring attention: sequence-parallel exact attention over a ring of ranks.

The counterpart of `setok_tpu/parallel/ring_attention.py`, and like it
plain tensor code, not a kernel (the JAX function reaches no
`pl.pallas_call`). The sequence is split over the ranks of a process group
(the `seq` axis of parallel/mesh.make_sp_mesh), in ring order = global
order. Q stays local; K and V rotate around the ring (i → i + 1, through
`batch_isend_irecv`, as `jax.lax.ppermute` does) while a flash-style
online softmax accumulates in float32. Peak memory per rank is
O(L_local²) instead of O(L²).

The rotation is an autograd Function whose transpose is the reverse
rotation (parallel/comm.rotate), so autograd differentiates the loop.
"""

from __future__ import annotations

from typing import Optional

import torch

from setok_tpu_torch.parallel import comm

NEG_INF = -1e30


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   group, causal: bool = True,
                   sm_scale: Optional[float] = None,
                   positions: Optional[torch.Tensor] = None,
                   valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Exact attention with K/V rotated around `group` (None: one rank).

    q/k/v: (B, H, L_local, D), the local sequence shard (all shards of
    equal length). Returns (B, H, L_local, D) in q's type.

    positions/valid: optional (B, L_local) hole-aware global positions and
    token validity of the local shard. They rotate with K/V, so causality
    compares semantic positions, as the dense path's mask does
    (models/llama.make_attention_mask). When omitted, causality uses raw
    ring order and every token is valid. A query that sees no key gives
    0."""
    n_dev = comm.group_size(group)
    my_idx = comm.group_rank(group)
    b, h, l_local, d = q.shape
    scale = sm_scale if sm_scale is not None else 1.0 / (d ** 0.5)
    dev = q.device

    q32 = q.float()
    if positions is None:
        q_pos = (my_idx * l_local + torch.arange(l_local, device=dev)
                 ).expand(b, l_local)
    else:
        q_pos = positions
    q_valid = (torch.ones((b, l_local), dtype=torch.bool, device=dev)
               if valid is None else valid > 0)

    m = torch.full((b, h, l_local, 1), -float("inf"), device=dev)
    l = torch.zeros((b, h, l_local, 1), device=dev)
    o = torch.zeros((b, h, l_local, d), device=dev)
    k_cur, v_cur, kv_pos, kv_valid = k, v, q_pos, q_valid
    for step in range(n_dev):
        s = torch.einsum("bhqd,bhkd->bhqk", q32, k_cur.float()) * scale
        allowed = kv_valid[:, None, :] & q_valid[:, :, None]
        if causal:
            allowed = allowed & (q_pos[:, :, None] >= kv_pos[:, None, :])
        allowed = allowed[:, None]
        s = torch.where(allowed, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        m_new = m_new.clamp_min(NEG_INF)
        corr = torch.exp(m - m_new)
        p = torch.where(allowed, torch.exp(s - m_new), 0.0)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        o = o * corr + torch.einsum("bhqk,bhkd->bhqd", p, v_cur.float())
        m = m_new
        if step + 1 < n_dev:
            # the JAX loop also permutes after its last step; that shift's
            # result is never read
            k_cur, v_cur = comm.rotate([k_cur, v_cur], group)
            kv_pos, kv_valid = comm.shift_ring([kv_pos, kv_valid], group)
    out = o / l.clamp_min(1e-30)
    return out.to(q.dtype)
