"""Point-sharded farthest point sampling (counterpart of
``mm3d_tpu/parallel/sharded_fps.py``).

The N axis of the cloud is split over the mesh's ``data`` axis. Each rank
keeps its tile of the points and its tile of the running min-distance
cache; a step computes the tile's candidate (largest distance, its first
index) and one all-gather of the ranks' candidates picks the global
farthest point on every rank: the largest distance, ties to the smallest
global index (the lowest rank holding it, its first lane), which is
``fps_torch``'s first-occurrence argmax. Every rank holds the whole cloud
(the model's activations are replicated), so the winner's coordinates are
read, not sent. One collective a step, O(N / world) work a rank.

The distances are ``fps_torch``'s, (dx*dx + dy*dy) + dz*dz elementwise, so
the indices are bit for bit the single-process op's.
"""

from __future__ import annotations

import torch

from mm3d_tpu_torch.parallel.mesh import DATA_AXIS, Mesh, all_gather


def tile_of(mesh: Mesh, n: int) -> slice:
    """This rank's contiguous tile of ``n`` points on the ``data`` axis;
    raises when ``n`` does not divide by the axis size."""
    w = mesh.shape[DATA_AXIS]
    if n % w:
        raise ValueError(f"N={n} not divisible by mesh axis "
                         f"{DATA_AXIS!r}={w}")
    t = n // w
    return slice(mesh.rank * t, (mesh.rank + 1) * t)


def sharded_fps(xyz: torch.Tensor, npoint: int, mesh: Mesh) -> torch.Tensor:
    """FPS over a point-sharded cloud, from index 0.

    Args:
      xyz: [B, N, 3], the same on every rank; N must divide by the mesh
        axis size.
      npoint: number of samples.
    Returns:
      [B, npoint] int32 global indices, identical to ``fps_torch``'s."""
    B, N, _ = xyz.shape
    tile = tile_of(mesh, N)
    xt = xyz[:, tile]
    x, y, z = xt[..., 0], xt[..., 1], xt[..., 2]
    batch = torch.arange(B, device=xyz.device)
    dist = torch.full(x.shape, 1e10, dtype=xyz.dtype, device=xyz.device)
    out = torch.zeros((B, npoint), dtype=torch.int32, device=xyz.device)
    bits = {torch.float32: torch.int32, torch.float64: torch.int64}[xyz.dtype]
    far = torch.zeros(B, dtype=torch.long, device=xyz.device)
    for i in range(npoint):
        out[:, i] = far
        c = xyz[batch, far]  # [B,3]: the winner, read from the whole cloud
        dx = x - c[:, 0:1]
        dy = y - c[:, 1:2]
        dz = z - c[:, 2:3]
        dist = torch.minimum(dist, (dx * dx + dy * dy) + dz * dz)
        lidx = torch.argmax(dist, dim=1)  # first lane of the max
        lmax = dist[batch, lidx]
        # one gather of (distance bits, global index), exact for any N
        cand = all_gather(torch.stack(
            [lmax.view(bits), (lidx + tile.start).to(bits)], dim=1), mesh)
        dmax = cand[..., 0].view(xyz.dtype)  # [W, B]
        gmax = dmax.amax(dim=0)
        # the first rank holding the max holds its smallest global index
        first = torch.argmax((dmax == gmax).to(torch.int8), dim=0)
        far = cand[first, batch, 1].long()
    return out
