"""Point-sharded ball query, kNN and the SA and FP tails (counterpart of
``mm3d_tpu/parallel/sharded_group.py``).

Every function takes the whole (replicated) tensors, works on this rank's
tile of the point axis and ends in a collective, so its result is the same
on every rank and equal to the single-process op's:

* ``sharded_ball_query``: first K in-radius points by ascending global
  index, empty slots the first hit, a centroid with no hit all zeros. Each
  rank ranks its tile's hits with a running count, offsets it by the hit
  counts of the lower ranks (one all-gather of [B,S] counts) and puts its
  share of the first K into their slots; a sum merges the slots.
* ``sharded_sa_group_max``: the eval SA tail (ball query, gather, the
  BN-folded MLP, max over neighbours). Max distributes over shards, so each
  rank runs the MLP over its own share of the first K hits and one max of
  the [B,S,C3] output merges the ranks; the payload is the output's size,
  not the tile's. A centroid with no hit takes global point 0, which rank 0
  supplies.
* ``sharded_knn_point``: each rank's K nearest of its tile, all-gathered,
  ordered by global index, then the K nearest of the pool by a stable sort,
  so ties go to the lower global index as in ``knn_point``. Needs tile >= K.
* ``sharded_idx_group_max``: the SA tail over given global indices (the kNN
  block's): each rank MLPs the slots its tile holds; one max merges.
* ``sharded_fp``: the eval FP tail. Each dense row's 3-NN and interpolation
  depend on that row alone, so each rank runs ``ops.fused_fp`` (the fused
  FP kernel on the card, its plain twin on the CPU) over its tile of rows,
  and one all-gather at the end returns the whole [B,N,C] on every rank:
  the output is gathered inside ``sharded_fp``, not left sharded, because
  the block's next layers run on every rank over all N rows.

The squared distances are ``geometry.square_distance``'s, the formula and
order of the single-process ball query and kNN, so a point exactly on the
radius falls on the same side (the JAX note at ``sharded_group.py:45-52``).
The per-shard work is plain PyTorch, as the JAX package runs no Pallas
kernel inside its ``shard_map``s, but for ``sharded_fp``'s.
"""

from __future__ import annotations

import torch

from mm3d_tpu_torch.ops.geometry import _gather, square_distance
from mm3d_tpu_torch.parallel.mesh import (DATA_AXIS, Mesh, all_gather,
                                          all_reduce)
from mm3d_tpu_torch.parallel.sharded_fps import tile_of


def _r2(radius: float, dtype: torch.dtype) -> float:
    """radius**2 rounded to the points' dtype, as ``ball_query_torch``."""
    return torch.tensor(radius * radius, dtype=dtype).item()


def _local_hits(radius: float, xyz: torch.Tensor, new_xyz: torch.Tensor,
                mesh: Mesh):
    """This rank's in-ball bookkeeping over its tile.

    Returns (tile slice, in_ball [B,S,t], global_rank [B,S,t] 1-based among
    all ranks' hits, local_rank [B,S,t] 1-based among this tile's, local
    count [B,S], global count [B,S])."""
    tile = tile_of(mesh, xyz.shape[1])
    d2 = square_distance(new_xyz, xyz[:, tile])  # [B,S,t]
    in_ball = d2 <= _r2(radius, xyz.dtype)
    local_rank = torch.cumsum(in_ball.to(torch.int32), dim=-1,
                              dtype=torch.int32)
    cnt = local_rank[..., -1]  # [B,S]
    cnt_all = all_gather(cnt, mesh)  # [W,B,S]
    prefix = cnt_all[:mesh.rank].sum(dim=0, dtype=torch.int32)
    global_rank = local_rank + prefix[..., None]
    return (tile, in_ball, global_rank, local_rank, cnt,
            cnt_all.sum(dim=0, dtype=torch.int32))


def _scatter_slots(live: torch.Tensor, slot: torch.Tensor,
                   value: torch.Tensor, K: int) -> torch.Tensor:
    """[B,S,K] int32: ``value`` where ``live`` at its ``slot`` (1-based), 0
    elsewhere; dead entries go to a dump slot K that is cut off."""
    B, S, _ = live.shape
    tgt = torch.where(live, slot - 1, torch.full_like(slot, K)).long()
    out = torch.zeros((B, S, K + 1), dtype=torch.int32, device=live.device)
    out.scatter_add_(2, tgt, torch.where(live, value,
                                         torch.zeros_like(value)))
    return out[..., :K]


def sharded_ball_query(radius: float, nsample: int, xyz: torch.Tensor,
                       new_xyz: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Ball query over a point-sharded cloud -> global indices [B,S,K]
    int32, ``ball_query_torch``'s contract."""
    tile, in_ball, grank, _, _, cnt_g = _local_hits(radius, xyz, new_xyz,
                                                    mesh)
    lane = torch.arange(tile.start, tile.stop, dtype=torch.int32,
                        device=xyz.device).expand(in_ball.shape)
    out = all_reduce(_scatter_slots(in_ball & (grank <= nsample), grank,
                                    lane, nsample), mesh)
    k = torch.arange(nsample, device=xyz.device)
    filled = k[None, None, :] < torch.clamp(cnt_g, min=1)[..., None]
    return torch.where(filled, out, out[..., :1])


def _mlp(h: torch.Tensor, cbias, w1, b1, w2, b2) -> torch.Tensor:
    """The folded MLP of ``cuda_kernels.fused_sa_idx_torch``, in h's dtype."""
    dt = h.dtype
    h = torch.relu(h + cbias.to(dt))
    h = torch.relu(torch.matmul(h, w1.to(dt)) + b1.to(dt))
    return torch.relu(torch.matmul(h, w2.to(dt)) + b2.to(dt))


def sharded_sa_group_max(radius: float, nsample: int, xyz: torch.Tensor,
                         new_xyz: torch.Tensor, pre: torch.Tensor,
                         cbias: torch.Tensor, w1: torch.Tensor,
                         b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
                         mesh: Mesh) -> torch.Tensor:
    """Eval SA tail on a point-sharded cloud -> [B,S,C3] in pre's dtype:
    ``cuda_kernels.fused_sa_torch``'s math (BN folded into ``pre`` [B,N,C1],
    ``cbias`` [B,S,C1] and the dense weights)."""
    K = nsample
    tile, in_ball, grank, lrank, lcnt, cnt_g = _local_hits(
        radius, xyz, new_xyz, mesh)
    t = tile.stop - tile.start
    lane = torch.arange(t, dtype=torch.int32, device=xyz.device).expand(
        in_ball.shape)
    # this tile's first K hits: a superset of its share of the global
    # first K, since a hit's global rank is at least its local rank
    lanes = _scatter_slots(in_ball & (lrank <= K), lrank, lane, K).long()
    g = _gather(pre[:, tile], lanes)  # [B,S,K,C1]
    k_live = ((torch.arange(K, device=xyz.device)[None, None, :]
               < lcnt[..., None])
              & (torch.gather(grank, 2, lanes) <= K))
    h = _mlp(g, cbias[:, :, None, :], w1, b1, w2, b2)
    h = torch.where(k_live[..., None], h, torch.full_like(h, -torch.inf))
    out = h.amax(dim=2)  # [B,S,C3]: this rank's partial max
    empty = (cnt_g == 0)[..., None]
    if mesh.rank == 0:
        # a centroid with no hit groups global point 0
        h0 = _mlp(pre[:, 0:1, :], cbias, w1, b1, w2, b2)
        out = torch.where(empty, h0, out)
    else:
        out = torch.where(empty, torch.full_like(out, -torch.inf), out)
    return all_reduce(out, mesh, "max")


def sharded_knn_point(nsample: int, xyz: torch.Tensor,
                      new_xyz: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """kNN over a point-sharded cloud -> global indices [B,S,K] int32,
    ``knn_point``'s: ascending distance, ties to the lower global index."""
    B, N, _ = xyz.shape
    S = new_xyz.shape[1]
    W = mesh.shape[DATA_AXIS]
    tile = tile_of(mesh, N)
    if N // W < nsample:
        raise ValueError(f"tile {N // W} < nsample {nsample}: kNN sharding "
                         "needs every shard to hold at least K candidates")
    d2 = square_distance(new_xyz, xyz[:, tile])  # [B,S,t]
    cand_d, lane = torch.sort(d2, dim=-1, stable=True)
    cand_d, lane = cand_d[..., :nsample], lane[..., :nsample]
    # [W,B,S,K] -> [B,S,W*K]: rank order is global-index order of the
    # tiles, and inside a tile the candidates are put in index order below
    all_d = all_gather(cand_d, mesh).permute(1, 2, 0, 3).reshape(
        B, S, W * nsample)
    all_i = all_gather(lane.to(torch.int32) + tile.start, mesh).permute(
        1, 2, 0, 3).reshape(B, S, W * nsample)
    order = torch.argsort(all_i, dim=-1, stable=True)
    all_d = torch.gather(all_d, 2, order)
    all_i = torch.gather(all_i, 2, order)
    pick = torch.sort(all_d, dim=-1, stable=True).indices[..., :nsample]
    return torch.gather(all_i, 2, pick)


def sharded_idx_group_max(idx: torch.Tensor, pre: torch.Tensor,
                          cbias: torch.Tensor, w1: torch.Tensor,
                          b1: torch.Tensor, w2: torch.Tensor,
                          b2: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Eval SA tail over given global indices ``idx`` [B,S,K] on a
    point-sharded ``pre`` [B,N,C1] -> [B,S,C3] in pre's dtype,
    ``cuda_kernels.fused_sa_idx_torch``'s math. Every slot belongs to one
    tile: each rank MLPs its own slots (the others -inf) and one max
    merges."""
    tile = tile_of(mesh, pre.shape[1])
    t = tile.stop - tile.start
    mine = (idx >= tile.start) & (idx < tile.stop)
    lanes = torch.clamp(idx.long() - tile.start, 0, t - 1)
    h = _mlp(_gather(pre[:, tile], lanes), cbias[:, :, None, :], w1, b1, w2,
             b2)
    h = torch.where(mine[..., None], h, torch.full_like(h, -torch.inf))
    return all_reduce(h.amax(dim=2), mesh, "max")


def sharded_fp(xyz1: torch.Tensor, xyz2: torch.Tensor, pre: torch.Tensor,
               skip: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Eval FP tail on a point-sharded dense cloud -> [B,N,C] in pre's
    dtype: relu(three_interpolate(pre, 3nn(xyz1 -> xyz2)) + skip), BN
    folded, as ``ops.fused_fp``. ``xyz1`` [B,N,3] and ``skip`` [B,N,C] are
    split by rows, ``xyz2`` [B,M,3] and ``pre`` [B,M,C] are whole. Each
    rank runs ``ops.fused_fp`` over its rows, then the rows are
    all-gathered, so the output is the whole [B,N,C] on every rank, bit for
    bit the single-process op's (rows are independent)."""
    from mm3d_tpu_torch import ops
    B, N, _ = xyz1.shape
    tile = tile_of(mesh, N)
    out = ops.fused_fp(xyz1[:, tile], xyz2, pre, skip[:, tile])
    rows = all_gather(out, mesh)  # [W,B,t,C]
    return rows.permute(1, 0, 2, 3).reshape(B, N, out.shape[-1])
