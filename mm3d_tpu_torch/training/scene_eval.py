"""Whole-room semantic-segmentation evaluation (counterpart of
``mm3d_tpu/training/scene_eval.py``; the lineage's test_semseg protocol).

A room is tiled into overlapping blocks of fixed size on the host (numpy,
the JAX package's tiling and seeds), each batch of blocks is predicted by
``predict_fn``, and each point's class probabilities are summed back onto
the room's points over every block and vote that holds it. The vote buffer
[N_room, C] f32 lives on the predictor's device: each batch's
``exp(log_probs)`` of its live blocks is scatter-added into it there
(``index_add_``), and the buffer is fetched once at the end. On the card
``index_add_`` sums in no fixed order, so two runs' votes may differ in
their last bits.

``predict_fn`` is any callable from tensors to log-probs: a
``make_predictor`` predictor, or a model's eval forward under ``no_grad``.
It is given host tensors and moves them itself.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from mm3d_tpu_torch.data.loaders import semseg_block_features


def block_point_lists(xyz: np.ndarray, block_size: float = 1.0,
                      stride: float = 0.5):
    """The point-index lists of the room's blocks; they do not depend on a
    seed.

    Candidates come from binning the points into stride cells, so a block
    tests only the points of its cells and their neighbours (one cell of
    slack absorbs float effects at the edges), then the exact bounds. Only
    empty blocks are skipped."""
    xmin, ymin = float(xyz[:, 0].min()), float(xyz[:, 1].min())
    xs = np.arange(xmin, xyz[:, 0].max() + 1e-6, stride)
    ys = np.arange(ymin, xyz[:, 1].max() + 1e-6, stride)
    cx = np.floor((xyz[:, 0] - xmin) / stride).astype(np.int64)
    cy = np.floor((xyz[:, 1] - ymin) / stride).astype(np.int64)
    ncy = int(cy.max()) + 2
    keys = cx * ncy + cy
    order = np.argsort(keys, kind="stable")
    sk = keys[order]
    uniq, starts = np.unique(sk, return_index=True)
    bounds = np.append(starts, len(sk))
    cells = {int(u): order[s:e]
             for u, s, e in zip(uniq, bounds[:-1], bounds[1:])}
    r = int(np.ceil(block_size / stride)) + 1
    sels = []
    for a, x0 in enumerate(xs):
        for b, y0 in enumerate(ys):
            cand = [cells[c] for c in
                    (ccx * ncy + ccy
                     for ccx in range(a - 1, a + r)
                     for ccy in range(b - 1, b + r)) if c in cells]
            if not cand:
                continue
            cand = np.concatenate(cand)
            cm = ((xyz[cand, 0] >= x0) & (xyz[cand, 0] < x0 + block_size)
                  & (xyz[cand, 1] >= y0) & (xyz[cand, 1] < y0 + block_size))
            sel = np.sort(cand[cm])
            if len(sel):
                sels.append(sel)
    return sels


def tile_scene(xyz: np.ndarray, rgb: Optional[np.ndarray],
               npoints: int = 4096, block_size: float = 1.0,
               stride: float = 0.5, seed: int = 0, block_lists=None):
    """Tile a room into overlapping blocks of exactly ``npoints`` points.

    Returns (features [nblocks, npoints, 9] f32, point_idx [nblocks,
    npoints] int32): each block row's point in the room. Every point of a
    block is covered (its points shuffled, cut into ceil(n / npoints)
    tiles, the last padded by resampling), so a point can appear more than
    once and its votes add up. ``block_lists`` (``block_point_lists``) can
    be computed once for all votes; only the subsampling follows ``seed``.
    """
    rng = np.random.RandomState(seed)
    room_min = xyz.min(0)
    room_extent = xyz.max(0) - room_min
    if rgb is None:
        rgb = np.zeros_like(xyz)
    if rgb.max() > 1.5:
        rgb = rgb / 255.0
    if block_lists is None:
        block_lists = block_point_lists(xyz, block_size, stride)
    feats_l, idx_l = [], []
    for sel in block_lists:
        sel = rng.permutation(sel)
        nchunks = max(1, int(np.ceil(len(sel) / npoints)))
        for c in range(nchunks):
            choice = sel[c * npoints:(c + 1) * npoints]
            if len(choice) < npoints:
                extra = rng.choice(sel, npoints - len(choice),
                                   replace=len(sel) < npoints)
                choice = np.concatenate([choice, extra])
            feats_l.append(semseg_block_features(
                xyz[choice], rgb[choice], room_min, room_extent))
            idx_l.append(choice.astype(np.int32))
    if not feats_l:
        raise ValueError("scene produced no blocks")
    return np.stack(feats_l), np.stack(idx_l)


def _accumulate_votes(votes: torch.Tensor, pidx: torch.Tensor,
                      log_probs: torch.Tensor,
                      live: torch.Tensor) -> torch.Tensor:
    """Scatter-add one batch's block probabilities into the room's vote
    buffer, in place on its device. votes [N_room, C] f32, pidx [B, npoints]
    int64, log_probs [B, npoints, C], live [B] f32 (0 for padding blocks).
    ``exp`` runs in the log-probs' dtype, the product in f32, as in the JAX
    package."""
    C = votes.shape[-1]
    contrib = torch.exp(log_probs) * live[:, None, None]
    return votes.index_add_(0, pidx.reshape(-1),
                            contrib.reshape(-1, C).to(votes.dtype))


def _vote_loop(predict_fn, arrays, pidx, nblocks, batch_size,
               n_room, num_classes):
    """Wrap-pad the per-block arrays to whole batches, predict each batch
    and add its votes on the predictor's device; one copy of the buffer to
    the host at the end. Shared by the point-only and the multimodal
    protocols."""
    pad = (-nblocks) % batch_size
    if pad:
        # wrap around: the pad can exceed nblocks for a small room
        rep = np.resize(np.arange(nblocks), pad)
        arrays = [np.concatenate([a, a[rep]], 0) for a in arrays]
        pidx = np.concatenate([pidx, pidx[rep]], 0)
    votes = None
    for s in range(0, nblocks + pad, batch_size):
        sl = slice(s, s + batch_size)
        logp = predict_fn(*(torch.from_numpy(np.ascontiguousarray(a[sl]))
                            for a in arrays))
        if votes is None:
            votes = torch.zeros((n_room, num_classes), dtype=torch.float32,
                                device=logp.device)
        live = torch.from_numpy(
            (s + np.arange(batch_size) < nblocks).astype(np.float32)).to(
                logp.device)
        idx = torch.from_numpy(pidx[sl].astype(np.int64)).to(logp.device)
        _accumulate_votes(votes, idx, logp, live)
    return votes.cpu().numpy()


def evaluate_scene(predict_fn: Callable, xyz: np.ndarray,
                   labels: Optional[np.ndarray] = None,
                   rgb: Optional[np.ndarray] = None,
                   num_classes: int = 13, npoints: int = 4096,
                   block_size: float = 1.0, stride: float = 0.5,
                   batch_size: int = 8, seed: int = 0,
                   num_votes: int = 1
                   ) -> Tuple[np.ndarray, Dict[str, float]]:
    """Per-point labels of a whole room.

    ``predict_fn``: (points [B, npoints, 9]) -> log_probs [B, npoints, C].
    Returns (pred [N] int32, metrics: ``coverage``, and with ``labels``
    ``point_acc``, ``miou`` and the confusion matrix ``_cm``).
    ``num_votes`` > 1 subsamples each block again with seed + v and adds
    the probabilities; the blocks stay the same."""
    bl = block_point_lists(xyz, block_size, stride)
    votes = None
    for v in range(num_votes):
        feats, pidx = tile_scene(xyz, rgb, npoints, block_size, stride,
                                 seed + v, block_lists=bl)
        vv = _vote_loop(predict_fn, [feats], pidx, feats.shape[0],
                        batch_size, len(xyz), num_classes)
        votes = vv if votes is None else votes + vv
    return _finish(votes, labels, num_classes)


def room_confusion(pred: np.ndarray, labels: np.ndarray,
                   num_classes: int) -> np.ndarray:
    """[C, C] confusion matrix (rows: the true class), a host bincount;
    shared by the one-room metrics and the whole-area sum. Labels outside
    [0, num_classes) (ignore markers such as -1 or 255, or a head smaller
    than the tree's classes) are left out."""
    labels = labels.astype(np.int64)
    valid = (labels >= 0) & (labels < num_classes)
    return np.bincount(
        labels[valid] * num_classes + pred.astype(np.int64)[valid],
        minlength=num_classes * num_classes
    ).reshape(num_classes, num_classes)


def metrics_from_confusion(cm: np.ndarray) -> Dict[str, float]:
    """point_acc and the mIoU over the classes present in the labels or the
    predictions (the lineage's whole-area convention)."""
    inter = np.diag(cm).astype(np.float64)
    union = cm.sum(0) + cm.sum(1) - np.diag(cm)
    present = (cm.sum(1) > 0) | (cm.sum(0) > 0)
    iou = np.where(union > 0, inter / np.maximum(union, 1), 1.0)
    total = cm.sum()
    return {
        "point_acc": float(inter.sum() / max(total, 1)),
        "miou": float(iou[present].mean()) if present.any() else 1.0,
    }


def _finish(votes, labels, num_classes):
    seen = votes.sum(-1) > 0
    pred = votes.argmax(-1).astype(np.int32)
    metrics: Dict[str, float] = {"coverage": float(seen.mean())}
    if labels is not None:
        # every point is scored: a point no block covered keeps class 0
        # and counts as wrong; ``coverage`` is the share with a vote
        cm = room_confusion(pred, labels, num_classes)
        metrics.update(metrics_from_confusion(cm))
        # for the whole-area sum (``test --scene DIR``)
        metrics["_cm"] = cm
    return pred, metrics


def render_block_views(feats: np.ndarray, hw=(64, 64), seed: int = 0):
    """A camera view of each block for the multimodal protocol: a depth
    image of the block's local xyz (``feats[..., :3]``) from a viewpoint
    drawn per block, as ``SyntheticMultimodal`` draws it.

    Returns (images [nb,H,W,3], K [nb,3,3], R [nb,3,3], t [nb,3])."""
    from mm3d_tpu_torch.data.synthetic import (default_intrinsics,
                                               random_viewpoint_extrinsics,
                                               render_depth_image)
    Kin = default_intrinsics(hw)
    imgs, Rs, ts = [], [], []
    for b in range(feats.shape[0]):
        rng = np.random.RandomState((seed * 7_000_003 + b) % (2**32))
        R, t = random_viewpoint_extrinsics(rng)
        imgs.append(render_depth_image(feats[b, :, :3], Kin, R, t, hw))
        Rs.append(R)
        ts.append(t)
    nb = feats.shape[0]
    return (np.stack(imgs), np.broadcast_to(Kin, (nb, 3, 3)).copy(),
            np.stack(Rs), np.stack(ts))


def evaluate_scene_multimodal(predict_fn: Callable, xyz: np.ndarray,
                              labels: Optional[np.ndarray] = None,
                              rgb: Optional[np.ndarray] = None,
                              num_classes: int = 13, npoints: int = 2048,
                              hw=(64, 64), block_size: float = 1.0,
                              stride: float = 0.5, batch_size: int = 8,
                              seed: int = 0, num_votes: int = 1
                              ) -> Tuple[np.ndarray, Dict[str, float]]:
    """The whole-room protocol of the multimodal per-point model (config
    5): ``evaluate_scene``'s tiling and votes, with a rendered view of each
    block for the image branch.

    ``predict_fn``: (points [B,npoints,9], image [B,H,W,3], K, R, t) ->
    log_probs [B,npoints,C]. Each vote's seed also renders the blocks'
    views from new viewpoints."""
    bl = block_point_lists(xyz, block_size, stride)
    votes = None
    for v in range(num_votes):
        feats, pidx = tile_scene(xyz, rgb, npoints, block_size, stride,
                                 seed + v, block_lists=bl)
        imgs, Kin, Rm, tm = render_block_views(feats, hw, seed + v)
        vv = _vote_loop(predict_fn, [feats, imgs, Kin, Rm, tm], pidx,
                        feats.shape[0], batch_size, len(xyz), num_classes)
        votes = vv if votes is None else votes + vv
    return _finish(votes, labels, num_classes)
