"""PointNet models and the losses of every model (counterpart of
``mm3d_tpu/models/pointnet.py``).

* ``STN`` (``pointnet.py:32-64``): the spatial transformer that predicts a
  k x k alignment matrix, SharedMLP [64, 128, 1024], max over the points,
  two Dense + BN + relu layers and a zero-initialised ``fc_out`` plus the
  identity. ``fc_out`` has no compute dtype and takes its input in f32, so
  the matrix is f32 in bf16 too;
* ``_stn_align`` (``:68-80``): the 3x3 alignment of the raw f32 xyz
  channels, written as f32 products and sums (no matmul, so no global TF32
  flag can round it: the counterpart of JAX's ``Precision.HIGHEST``), then
  the cast to the block's compute dtype;
* ``PointNetEncoder`` (``:82-131``): input STN, ``mlp1``, the feature STN
  ``fstn``, ``mlp2``, ``conv3`` + ``bn3`` with no relu, the global max, and
  for ``global_feat=False`` the per-point concat [point_feat, global]. With
  ``f32_train_guard`` the input STN and ``mlp1`` compute in f32 during bf16
  training (``fstn`` keeps the block dtype, as in JAX);
* the models: ``PointNetCls`` (config 1, ``pointnet_cls``), whose head is
  fc2 -> dropout -> bn2 -> relu; ``PointNetPartSeg`` and the lineage's
  ``PointNetPartSegLineage``; ``PointNetSemSeg``. Each returns
  (f32 log-probabilities, {"trans_feat": the feature transform});
* the losses: ``nll_loss``, ``feature_transform_regularizer`` (mean
  ||I - A A^T||_F in f32) and ``pointnet_loss``, their sum.

Parameter names follow the flax tree, so ``utils.jax_import`` maps them
one to one. No geometry kernel runs on these models: their work is dense
matmuls.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from mm3d_tpu_torch.models.layers import (BatchNorm, Dense, Dropout,
                                          SharedMLP, guarded_train_dtype,
                                          log_softmax_head)


class _ZeroDense(Dense):
    """A Dense whose kernel and bias start at zero (the STN's ``fc_out``)."""

    def init_(self, g):
        with torch.no_grad():
            self.kernel.zero_()
            self.bias.zero_()


class STN(nn.Module):
    """Spatial transformer: a k x k alignment matrix (STN3d / STNkd) of
    ``in_channels``-channel points; the matrix is f32 whatever the dtype."""

    def __init__(self, in_channels: int, k: int = 3, dtype=None):
        super().__init__()
        self.k = k
        self.dtype = dtype
        self.mlp = SharedMLP(in_channels, (64, 128, 1024), dtype=dtype)
        for i, (c_in, c_out) in enumerate(((1024, 512), (512, 256))):
            self.add_module(f"fc_{i}", Dense(c_in, c_out, dtype))
            self.add_module(f"fcbn_{i}", BatchNorm(c_out, dtype=dtype))
        self.fc_out = _ZeroDense(256, k * k)

    def forward(self, x: torch.Tensor, bn_momentum: float = 0.1,
                f32: bool = False) -> torch.Tensor:
        """x [B,N,C_in] -> [B,k,k] f32; ``f32`` computes in f32 whatever the
        module's dtype (the encoder's bf16 training guard)."""
        h = self.mlp(x, bn_momentum, f32=f32).amax(dim=1)  # [B,1024]
        for i in range(2):
            h = getattr(self, f"fc_{i}")(h, f32=f32)
            h = torch.relu(getattr(self, f"fcbn_{i}")(
                h, momentum=bn_momentum, f32=f32))
        # h in f32 (also from f64: JAX's astype), promoted to the
        # parameters' dtype as flax promotes it
        k = self.fc_out.kernel
        mat = self.fc_out(h.float().to(torch.promote_types(torch.float32,
                                                           k.dtype)))
        eye = torch.eye(self.k, dtype=mat.dtype, device=mat.device)
        return mat.reshape(-1, self.k, self.k) + eye


def _stn_align(x: torch.Tensor, trans: torch.Tensor, dtype) -> torch.Tensor:
    """The 3x3 alignment of x's xyz channels (x[..., :3] as given, before
    any cast, taken to f32 as JAX does) by ``trans`` in f32 (in the
    matrix's dtype where that is wider), the other channels re-attached,
    then the cast to ``dtype`` (None: none)."""
    ct = torch.promote_types(torch.float32, trans.dtype)
    p, t = x[..., :3].float().to(ct), trans.to(ct)
    # xyz[b,n,d] = sum_c p[b,n,c] t[b,c,d], as elementwise f32 products
    xyz = (p[..., 0:1] * t[:, None, 0, :] + p[..., 1:2] * t[:, None, 1, :]
           + p[..., 2:3] * t[:, None, 2, :])
    if x.shape[-1] > 3:
        x = torch.cat([xyz.to(x.dtype), x[..., 3:]], dim=-1)
    else:
        x = xyz.to(x.dtype)
    return x.to(dtype) if dtype is not None else x


class PointNetEncoder(nn.Module):
    """Shared-MLP encoder with the input and (optionally) feature STNs.

    Returns (global feature [B,1024], or per point [B,N,64+1024] with
    ``global_feat=False``; trans [B,3,3]; trans_feat [B,64,64] or None)."""

    def __init__(self, global_feat: bool = True,
                 feature_transform: bool = False, channel: int = 3,
                 dtype=None, f32_train_guard: bool = False):
        super().__init__()
        self.global_feat = global_feat
        self.feature_transform = feature_transform
        self.channel = channel
        self.dtype = dtype
        self.f32_train_guard = f32_train_guard
        self.stn = STN(channel, 3, dtype)
        self.mlp1 = SharedMLP(channel, (64,), dtype=dtype)
        if feature_transform:
            self.fstn = STN(64, 64, dtype)
        self.mlp2 = SharedMLP(64, (128,), dtype=dtype)
        self.conv3 = Dense(128, 1024, dtype)
        self.bn3 = BatchNorm(1024, dtype=dtype)

    def forward(self, x: torch.Tensor, bn_momentum: float = 0.1):
        B, N, C = x.shape
        if C != self.channel:
            raise ValueError(f"PointNetEncoder(channel={self.channel}) got "
                             f"{C}-channel input")
        dt = guarded_train_dtype(self.dtype, self.training,
                                 self.f32_train_guard)
        f32 = dt is None
        # the input STN sees the raw features the guard protects
        trans = self.stn(x, bn_momentum, f32=f32)
        x = _stn_align(x, trans, dt)
        x = self.mlp1(x, bn_momentum, f32=f32)
        trans_feat = None
        if self.feature_transform:
            # at the block dtype, as in JAX
            trans_feat = self.fstn(x, bn_momentum)
            x = torch.matmul(x, trans_feat.to(x.dtype))
        point_feat = x
        x = self.mlp2(x, bn_momentum)
        x = self.bn3(self.conv3(x), momentum=bn_momentum)  # no relu
        gf = x.amax(dim=1)  # [B,1024]
        if self.global_feat:
            return gf, trans, trans_feat
        ct = torch.promote_types(point_feat.dtype, gf.dtype)
        tiled = gf[:, None, :].to(ct).expand(B, N, gf.shape[-1])
        return (torch.cat([point_feat.to(ct), tiled], dim=-1), trans,
                trans_feat)


class PointNetCls(nn.Module):
    """Config 1 (BASELINE.json:7), ``pointnet_cls``: PointNet
    classification with the feature transform."""

    def __init__(self, num_class: int = 40, normal_channel: bool = False,
                 dtype=None):
        super().__init__()
        self.channel = 6 if normal_channel else 3
        self.feat = PointNetEncoder(True, True, self.channel, dtype)
        self.fc1 = Dense(1024, 512, dtype)
        self.bn1 = BatchNorm(512, dtype=dtype)
        self.fc2 = Dense(512, 256, dtype)
        self.drop = Dropout(0.4)
        self.bn2 = BatchNorm(256, dtype=dtype)
        self.fc3 = Dense(256, num_class, dtype)

    def forward(self, points, bn_momentum: float = 0.1,
                deterministic: Optional[bool] = None,
                generator: Optional[torch.Generator] = None,
                fps_generator: Optional[torch.Generator] = None):
        """points [B,N,3(+3)] f32 -> (log_probs [B,num_class] f32,
        {"trans_feat": [B,64,64] f32}). Dropout (after fc2, before bn2)
        runs unless ``deterministic`` (default: not training), its mask
        from ``generator``; there is no FPS, so ``fps_generator`` is
        unused."""
        det = (not self.training) if deterministic is None else deterministic
        feat, _, trans_feat = self.feat(points[..., :self.channel],
                                        bn_momentum)
        x = torch.relu(self.bn1(self.fc1(feat), momentum=bn_momentum))
        x = self.drop(self.fc2(x), det, generator)
        x = torch.relu(self.bn2(x, momentum=bn_momentum))
        return (log_softmax_head(self.fc3(x).float()),
                {"trans_feat": trans_feat})


class _PartSegBase(nn.Module):
    """The input side both PointNet part-seg models share: the channel
    choice and the input STN with its alignment."""

    def __init__(self, num_part: int, num_category: int,
                 normal_channel: bool, dtype):
        super().__init__()
        self.num_part, self.num_category = num_part, num_category
        self.channel = 6 if normal_channel else 3
        self.dtype = dtype
        self.stn = STN(self.channel, 3, dtype)

    def _aligned(self, points, bn_momentum):
        x = points[..., :self.channel]
        return _stn_align(x, self.stn(x, bn_momentum), self.dtype)

    def _tiled_global(self, out, cls_label_onehot, N):
        """[B,N,C+num_category]: the max over the points of ``out`` with the
        category one-hot, the same for every point."""
        gf = out.amax(dim=1)
        gf = torch.cat([gf, cls_label_onehot.to(gf.dtype)], dim=-1)
        return gf[:, None, :].expand(gf.shape[0], N, gf.shape[-1])


class PointNetPartSeg(_PartSegBase):
    """``pointnet_part_seg``: per-point part logits with the category one-hot
    (``pointnet.py:164-200``); the head's skip set is [global + one-hot,
    out1, the transformed features, out2, out3]."""

    def __init__(self, num_part: int = 50, num_category: int = 16,
                 normal_channel: bool = False, dtype=None):
        super().__init__(num_part, num_category, normal_channel, dtype)
        self.mlp1 = SharedMLP(self.channel, (64, 128, 128), dtype=dtype)
        self.fstn = STN(128, 128, dtype)
        self.mlp2 = SharedMLP(128, (512,), dtype=dtype)
        self.conv3 = Dense(512, 2048, dtype)
        self.bn3 = BatchNorm(2048, dtype=dtype)
        c_head = 2048 + num_category + 128 + 128 + 512 + 2048
        self.head_mlp = SharedMLP(c_head, (256, 256, 128), dtype=dtype)
        self.head_out = Dense(128, num_part, dtype)

    def forward(self, points: torch.Tensor, cls_label_onehot: torch.Tensor,
                bn_momentum: float = 0.1,
                deterministic: Optional[bool] = None,
                generator: Optional[torch.Generator] = None,
                fps_generator: Optional[torch.Generator] = None):
        """points [B,N,3(+3)] f32, cls_label_onehot [B,num_category] ->
        (log_probs [B,N,num_part] f32, {"trans_feat": [B,128,128]}). No
        dropout and no FPS: the other arguments are unused."""
        N = points.shape[1]
        out1 = self.mlp1(self._aligned(points, bn_momentum), bn_momentum)
        trans_feat = self.fstn(out1, bn_momentum)
        net = torch.matmul(out1, trans_feat.to(out1.dtype))
        out2 = self.mlp2(net, bn_momentum)
        out3 = self.bn3(self.conv3(out2), momentum=bn_momentum)
        concat = torch.cat([self._tiled_global(out3, cls_label_onehot, N),
                            out1, net, out2, out3], dim=-1)
        h = self.head_out(self.head_mlp(concat, bn_momentum))
        return log_softmax_head(h.float()), {"trans_feat": trans_feat}


class PointNetPartSegLineage(_PartSegBase):
    """``pointnet_part_seg_lineage``: the public lineage's part-seg dataflow
    (``pointnet.py:203-263``), so its checkpoints map one to one: conv1..5 /
    bn1..5 (``bn5`` with no relu before the global max), the feature STN on
    out3, and the head convs1..4 / bns1..3 over [global + one-hot, out1,
    out2, out3 (before the transform), out4, out5] = 4944 channels."""

    _WIDTHS = (64, 128, 128, 512, 2048)

    def __init__(self, num_part: int = 50, num_category: int = 16,
                 normal_channel: bool = False, dtype=None):
        super().__init__(num_part, num_category, normal_channel, dtype)
        c = self.channel
        for i, f in enumerate(self._WIDTHS, start=1):
            self.add_module(f"conv{i}", Dense(c, f, dtype))
            self.add_module(f"bn{i}", BatchNorm(f, dtype=dtype))
            c = f
        self.fstn = STN(128, 128, dtype)
        c = 2048 + num_category + sum(self._WIDTHS)
        for i, f in enumerate((256, 256, 128), start=1):
            self.add_module(f"convs{i}", Dense(c, f, dtype))
            self.add_module(f"bns{i}", BatchNorm(f, dtype=dtype))
            c = f
        self.convs4 = Dense(128, num_part, dtype)

    def _conv_bn(self, h, i, bn_momentum, act=True):
        h = getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(h),
                                    momentum=bn_momentum)
        return torch.relu(h) if act else h

    def forward(self, points: torch.Tensor, cls_label_onehot: torch.Tensor,
                bn_momentum: float = 0.1,
                deterministic: Optional[bool] = None,
                generator: Optional[torch.Generator] = None,
                fps_generator: Optional[torch.Generator] = None):
        """As ``PointNetPartSeg.forward``."""
        N = points.shape[1]
        out1 = self._conv_bn(self._aligned(points, bn_momentum), 1,
                             bn_momentum)
        out2 = self._conv_bn(out1, 2, bn_momentum)
        out3 = self._conv_bn(out2, 3, bn_momentum)
        trans_feat = self.fstn(out3, bn_momentum)
        net = torch.matmul(out3, trans_feat.to(out3.dtype))
        out4 = self._conv_bn(net, 4, bn_momentum)
        out5 = self._conv_bn(out4, 5, bn_momentum, act=False)
        h = torch.cat([self._tiled_global(out5, cls_label_onehot, N),
                       out1, out2, out3, out4, out5], dim=-1)
        for i in range(1, 4):
            h = torch.relu(getattr(self, f"bns{i}")(
                getattr(self, f"convs{i}")(h), momentum=bn_momentum))
        h = self.convs4(h)
        return log_softmax_head(h.float()), {"trans_feat": trans_feat}


class PointNetSemSeg(nn.Module):
    """``pointnet_sem_seg``: the per-point encoder over 9-dim block features
    (its input STN and ``mlp1`` in f32 during bf16 training), then the
    [512, 256, 128] head (``pointnet.py:266-283``)."""

    def __init__(self, num_class: int = 13, channel: int = 9, dtype=None):
        super().__init__()
        self.feat = PointNetEncoder(False, True, channel, dtype,
                                    f32_train_guard=True)
        self.head_mlp = SharedMLP(64 + 1024, (512, 256, 128), dtype=dtype)
        self.head_out = Dense(128, num_class, dtype)

    def forward(self, points: torch.Tensor, bn_momentum: float = 0.1,
                deterministic: Optional[bool] = None,
                generator: Optional[torch.Generator] = None,
                fps_generator: Optional[torch.Generator] = None):
        """points [B,N,9] f32 -> (log_probs [B,N,num_class] f32,
        {"trans_feat": [B,64,64]}). No dropout and no FPS: the other
        arguments are unused."""
        feat, _, trans_feat = self.feat(points, bn_momentum)
        h = self.head_out(self.head_mlp(feat, bn_momentum))
        return log_softmax_head(h.float()), {"trans_feat": trans_feat}


# ------------------------------------------------------------------ losses


def feature_transform_regularizer(trans: torch.Tensor,
                                  row_mask: Optional[torch.Tensor] = None
                                  ) -> torch.Tensor:
    """mean ||I - A A^T||_F over the batch, in f32 (the orthogonality
    penalty). ``row_mask`` [B] drops rows (eval's wrap-pad duplicates) from
    the mean."""
    k = trans.shape[-1]
    trans = trans.float()
    eye = torch.eye(k, dtype=trans.dtype, device=trans.device)
    diff = eye - torch.matmul(trans, trans.transpose(1, 2))
    # eps inside the sqrt: the STN starts at exactly the identity, where
    # the norm's gradient is NaN without it
    val = torch.sqrt(diff.reshape(diff.shape[0], -1).square().sum(1) + 1e-12)
    if row_mask is not None:
        rm = row_mask.to(val.dtype)
        return torch.sum(val * rm) / torch.clamp(torch.sum(rm), min=1.0)
    return torch.mean(val)


def nll_loss(log_probs: torch.Tensor, target: torch.Tensor,
             weight: Optional[torch.Tensor] = None,
             row_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """NLL on log-probabilities; log_probs [..., K], target [...] int.

    ``row_mask`` [B] (target's leading axis) excludes padded rows from the
    mean; class ``weight`` and the mask compose (both weight the sum)."""
    picked = torch.gather(log_probs, -1, target.long()[..., None])[..., 0]
    w = weight[target.long()] if weight is not None else None
    if row_mask is not None:
        rm = row_mask.reshape(
            row_mask.shape + (1,) * (picked.dim() - 1)).to(picked.dtype)
        rm = rm.expand(picked.shape)
        w = rm if w is None else w * rm
    if w is not None:
        return -torch.sum(picked * w) / torch.clamp(torch.sum(w), min=1e-9)
    return -torch.mean(picked)


def pointnet_loss(log_probs, target, aux, mat_diff_loss_scale: float = 0.001,
                  weight: Optional[torch.Tensor] = None,
                  row_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """NLL + ``mat_diff_loss_scale`` x the orthogonality regulariser of the
    feature transform (``aux["trans_feat"]``, where the model has one)."""
    loss = nll_loss(log_probs, target, weight, row_mask=row_mask)
    tf = aux.get("trans_feat") if aux else None
    if tf is not None:
        loss = loss + mat_diff_loss_scale * feature_transform_regularizer(
            tf, row_mask=row_mask)
    return loss
