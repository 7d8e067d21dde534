"""Canonical-lineage torch checkpoint import and export (counterpart of
``mm3d_tpu/utils/torch_import.py``).

The public PyTorch lineage of these models (yanx27-style module names)
stores checkpoints as ``state_dict``s: SA blocks as ``mlp_convs.{i}`` /
``mlp_bns.{i}`` (Conv2d), MSG blocks as ``conv_blocks.{s}.{l}`` /
``bn_blocks.{s}.{l}``, FP blocks as ``mlp_convs.{i}`` (Conv1d), heads as
``fc1/bn1/fc2/bn2/fc3`` (cls) or ``conv1/bn1/conv2`` (dense predictions),
and the plain-PointNet encoder as ``feat.stn.conv1...`` / ``feat.conv1...``.
The port's parameter names follow the JAX package's flax tree, so the map
is the JAX package's, carried out on a flax-layout numpy tree
(``utils.jax_import.to_jax_tree`` of a port model gives the template,
``load_jax_variables`` loads the result into it):

* conv weights ``[Cout, Cin, 1(,1)]`` <-> dense kernels ``[Cin, Cout]``;
* BN ``weight/bias/running_mean/running_var`` <-> ``scale/bias`` params and
  ``mean/var`` batch_stats;
* project-first SA/FP blocks: the lineage's layer 0 is ``proj_kernel`` /
  ``proj_bias`` / ``proj_bn``, layers 1.. are ``mlp_rest`` ``dense_{i-1}``
  / ``bn_{i-1}``; the FP ``proj_kernel`` rows are ``[skip; interp]``, the
  lineage's ``cat([points1, interpolated], -1)``; SA input rows are
  ``[xyz; feats]``, its ``cat([grouped_xyz_norm, grouped_points], -1)``.

The multimodal fusion models (configs 4-5) have no lineage layout and are
refused; so is ``pointnet_part_seg``, whose head concatenates another skip
set than the lineage's (``pointnet_part_seg_lineage`` maps one to one).
Where both concatenate the same features in another order (the plain
sem-seg encoder's output: here [point; global], the lineage's [global;
point]) the head's input channels are permuted in transit
(``_SEMSEG_HEAD_PERM``).
"""

from __future__ import annotations

import copy
from typing import Dict

import numpy as np
from torch import nn

from mm3d_tpu_torch.utils.jax_import import load_jax_variables, to_jax_tree


# --------------------------------------------------------------- tree ops

def _get(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def _set(tree, path, value):
    for p in path[:-1]:
        tree = tree.setdefault(p, {})
    old = tree.get(path[-1])
    if old is not None and np.shape(old) != np.shape(value):
        raise ValueError(f"shape mismatch at {'/'.join(path)}: checkpoint "
                         f"{np.shape(value)} vs model {np.shape(old)}")
    tree[path[-1]] = np.asarray(value, np.float32)


def _np(x):
    if hasattr(x, "detach"):  # torch tensor
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float32)


# ---------------------------------------------------- per-layer converters

class _Walker:
    """Shared traversal for import (sd -> variables) and export."""

    def __init__(self, params, stats, sd, mode):
        self.p, self.s, self.sd, self.mode = params, stats, sd, mode

    # conv/linear weight <-> dense kernel.  `perm` reorders INPUT
    # channels (our row i <- canonical row perm[i]) where the two
    # frameworks concatenate the same features in a different order.
    def dense(self, ckey, fpath, kind, perm=None):
        trail = {"conv2": (1, 1), "conv1": (1,), "linear": ()}[kind]
        if self.mode == "import":
            w = _np(self.sd[f"{ckey}.weight"])
            w = w.reshape(w.shape[0], w.shape[1])  # drop 1x1 spatial
            k = w.T
            if perm is not None:
                k = k[perm]
            _set(self.p, fpath + ("kernel",), k)
            _set(self.p, fpath + ("bias",), _np(self.sd[f"{ckey}.bias"]))
        else:
            k = np.asarray(_get(self.p, fpath + ("kernel",)))
            if perm is not None:
                k = k[np.argsort(perm)]
            self.sd[f"{ckey}.weight"] = k.T.reshape(k.shape[1], k.shape[0],
                                                    *trail)
            self.sd[f"{ckey}.bias"] = np.asarray(
                _get(self.p, fpath + ("bias",)))

    # a bare kernel param (project-first proj_kernel / proj_bias)
    def proj(self, ckey, fprefix, kind):
        trail = {"conv2": (1, 1), "conv1": (1,)}[kind]
        if self.mode == "import":
            w = _np(self.sd[f"{ckey}.weight"])
            w = w.reshape(w.shape[0], w.shape[1])
            _set(self.p, fprefix + ("proj_kernel",), w.T)
            _set(self.p, fprefix + ("proj_bias",),
                 _np(self.sd[f"{ckey}.bias"]))
        else:
            k = np.asarray(_get(self.p, fprefix + ("proj_kernel",)))
            self.sd[f"{ckey}.weight"] = k.T.reshape(k.shape[1], k.shape[0],
                                                    *trail)
            self.sd[f"{ckey}.bias"] = np.asarray(
                _get(self.p, fprefix + ("proj_bias",)))

    def bn(self, ckey, fpath):
        if self.mode == "import":
            _set(self.p, fpath + ("scale",), _np(self.sd[f"{ckey}.weight"]))
            _set(self.p, fpath + ("bias",), _np(self.sd[f"{ckey}.bias"]))
            _set(self.s, fpath + ("mean",),
                 _np(self.sd[f"{ckey}.running_mean"]))
            _set(self.s, fpath + ("var",),
                 _np(self.sd[f"{ckey}.running_var"]))
        else:
            self.sd[f"{ckey}.weight"] = np.asarray(
                _get(self.p, fpath + ("scale",)))
            self.sd[f"{ckey}.bias"] = np.asarray(
                _get(self.p, fpath + ("bias",)))
            self.sd[f"{ckey}.running_mean"] = np.asarray(
                _get(self.s, fpath + ("mean",)))
            self.sd[f"{ckey}.running_var"] = np.asarray(
                _get(self.s, fpath + ("var",)))

    # ------------------------------------------------------------- blocks

    def shared_mlp(self, cconv, cbn, fprefix, n, kind="conv2", start=0):
        """Canonical conv/bn stacks -> flax SharedMLP dense_i/bn_i."""
        for i in range(n):
            self.dense(f"{cconv}.{i + start}", fprefix + (f"dense_{i}",),
                       kind)
            self.bn(f"{cbn}.{i + start}", fprefix + (f"bn_{i}",))

    def sa_proj(self, canon, flax, n, kind="conv2"):
        """Project-first SA/FP block: canonical layer 0 ->
        proj_kernel/proj_bias/proj_bn, layers 1.. -> mlp_rest."""
        cconv = f"{canon}.mlp_convs"
        cbn = f"{canon}.mlp_bns"
        self.proj(f"{cconv}.0", (flax,), kind)
        self.bn(f"{cbn}.0", (flax, "proj_bn"))
        if n > 1:
            self.shared_mlp(cconv, cbn, (flax, "mlp_rest"),
                            n - 1, kind, start=1)

    def sa_msg(self, canon, flax, layers_per_scale):
        for sidx, n in enumerate(layers_per_scale):
            cconv = f"{canon}.conv_blocks.{sidx}"
            cbn = f"{canon}.bn_blocks.{sidx}"
            sfx = f"_{sidx}"
            if self.mode == "export":
                self._export_proj_msg(cconv, flax, sfx)
            else:
                self._import_proj_msg(cconv, flax, sfx)
            self.bn(f"{cbn}.0", (flax, f"proj_bn{sfx}"))
            if n > 1:
                self.shared_mlp(cconv, cbn, (flax, f"mlp_rest{sfx}"),
                                n - 1, "conv2", start=1)

    def _import_proj_msg(self, cconv, flax, sfx):
        w = _np(self.sd[f"{cconv}.0.weight"])
        w = w.reshape(w.shape[0], w.shape[1])
        _set(self.p, (flax, f"proj_kernel{sfx}"), w.T)
        _set(self.p, (flax, f"proj_bias{sfx}"),
             _np(self.sd[f"{cconv}.0.bias"]))

    def _export_proj_msg(self, cconv, flax, sfx):
        k = np.asarray(_get(self.p, (flax, f"proj_kernel{sfx}")))
        self.sd[f"{cconv}.0.weight"] = k.T.reshape(k.shape[1], k.shape[0],
                                                   1, 1)
        self.sd[f"{cconv}.0.bias"] = np.asarray(
            _get(self.p, (flax, f"proj_bias{sfx}")))

    def sa_plain(self, canon, flax, n):
        """group_all SA: flax keeps the plain SharedMLP layout."""
        self.shared_mlp(f"{canon}.mlp_convs", f"{canon}.mlp_bns",
                        (flax, "mlp"), n, "conv2")

    def fc_bn(self, cfc, cbn, ffc, fbn):
        self.dense(cfc, (ffc,), "linear")
        self.bn(cbn, (fbn,))

    def stn(self, canon, flax):
        """Canonical STN3d/STNkd -> our STN module."""
        for i in range(3):
            self.dense(f"{canon}.conv{i + 1}", (flax, "mlp", f"dense_{i}"),
                       "conv1")
            self.bn(f"{canon}.bn{i + 1}", (flax, "mlp", f"bn_{i}"))
        for i in range(2):
            self.dense(f"{canon}.fc{i + 1}", (flax, f"fc_{i}"), "linear")
            self.bn(f"{canon}.bn{i + 4}", (flax, f"fcbn_{i}"))
        self.dense(f"{canon}.fc3", (flax, "fc_out"), "linear")


# --------------------------------------------------------------- per-model

def _walk_pointnet2_cls_ssg(w: _Walker):
    for name, n in (("sa1", 3), ("sa2", 3)):
        w.sa_proj(name, name, n)
    w.sa_plain("sa3", "sa3", 3)
    w.fc_bn("fc1", "bn1", "fc1", "bn1")
    w.fc_bn("fc2", "bn2", "fc2", "bn2")
    w.dense("fc3", ("fc3",), "linear")


def _walk_pointnet2_cls_msg(w: _Walker):
    w.sa_msg("sa1", "sa1", [3, 3, 3])
    w.sa_msg("sa2", "sa2", [3, 3, 3])
    w.sa_plain("sa3", "sa3", 3)
    w.fc_bn("fc1", "bn1", "fc1", "bn1")
    w.fc_bn("fc2", "bn2", "fc2", "bn2")
    w.dense("fc3", ("fc3",), "linear")


def _walk_pointnet2_sem_seg(w: _Walker):
    for name in ("sa1", "sa2", "sa3", "sa4"):
        w.sa_proj(name, name, 3)
    for name, n in (("fp4", 2), ("fp3", 2), ("fp2", 2), ("fp1", 3)):
        w.sa_proj(name, name, n, kind="conv1")
    w.dense("conv1", ("head_mlp", "dense_0"), "conv1")
    w.bn("bn1", ("head_mlp", "bn_0"))
    w.dense("conv2", ("head_out",), "conv1")


def _walk_pointnet2_part_seg_ssg(w: _Walker):
    for name in ("sa1", "sa2"):
        w.sa_proj(name, name, 3)
    w.sa_plain("sa3", "sa3", 3)
    for name, n in (("fp3", 2), ("fp2", 2), ("fp1", 3)):
        w.sa_proj(name, name, n, kind="conv1")
    w.dense("conv1", ("head_mlp", "dense_0"), "conv1")
    w.bn("bn1", ("head_mlp", "bn_0"))
    w.dense("conv2", ("head_out",), "conv1")


def _walk_pointnet2_part_seg_msg(w: _Walker):
    w.sa_msg("sa1", "sa1", [3, 3, 3])
    w.sa_msg("sa2", "sa2", [3, 3])
    w.sa_plain("sa3", "sa3", 3)
    for name, n in (("fp3", 2), ("fp2", 2), ("fp1", 2)):
        w.sa_proj(name, name, n, kind="conv1")
    w.dense("conv1", ("head_mlp", "dense_0"), "conv1")
    w.bn("bn1", ("head_mlp", "bn_0"))
    w.dense("conv2", ("head_out",), "conv1")


def _walk_pointnet2_sem_seg_msg(w: _Walker):
    """Canonical pointnet2_sem_seg_msg: identical stage/mlp structure
    to ours (4x two-scale MSG SA + 4 FP + conv1/bn1/conv2 head)."""
    for name in ("sa1", "sa2", "sa3", "sa4"):
        w.sa_msg(name, name, [3, 3])
    for name, n in (("fp4", 2), ("fp3", 2), ("fp2", 2), ("fp1", 3)):
        w.sa_proj(name, name, n, kind="conv1")
    w.dense("conv1", ("head_mlp", "dense_0"), "conv1")
    w.bn("bn1", ("head_mlp", "bn_0"))
    w.dense("conv2", ("head_out",), "conv1")


def _walk_encoder(w: _Walker):
    """Canonical PointNetEncoder (``feat.*``) -> our encoder subtree.
    Shared by pointnet_cls (global_feat) and pointnet_sem_seg."""
    w.stn("feat.stn", "stn")
    w.stn("feat.fstn", "fstn")
    w.dense("feat.conv1", ("mlp1", "dense_0"), "conv1")
    w.bn("feat.bn1", ("mlp1", "bn_0"))
    w.dense("feat.conv2", ("mlp2", "dense_0"), "conv1")
    w.bn("feat.bn2", ("mlp2", "bn_0"))
    w.dense("feat.conv3", ("conv3",), "conv1")
    w.bn("feat.bn3", ("bn3",))


def _walk_pointnet_part_seg_lineage(w: _Walker):
    """Canonical pointnet_part_seg: a direct rename — the flax variant
    (PointNetPartSegLineage) keeps the canonical module names."""
    w.stn("stn", "stn")
    w.stn("fstn", "fstn")
    for i in range(1, 6):
        w.dense(f"conv{i}", (f"conv{i}",), "conv1")
        w.bn(f"bn{i}", (f"bn{i}",))
    for i in range(1, 4):
        w.dense(f"convs{i}", (f"convs{i}",), "conv1")
        w.bn(f"bns{i}", (f"bns{i}",))
    w.dense("convs4", ("convs4",), "conv1")


def _walk_pointnet_cls_top(w: _Walker):
    w.fc_bn("fc1", "bn1", "fc1", "bn1")
    w.fc_bn("fc2", "bn2", "fc2", "bn2")
    w.dense("fc3", ("fc3",), "linear")


# canonical pointnet_sem_seg's conv1 consumes the encoder output as
# cat([global(1024), point(64)]); our encoder emits cat([point(64),
# global(1024)]) -- permute the head's input channels accordingly
_SEMSEG_HEAD_PERM = np.concatenate(
    [np.arange(64) + 1024, np.arange(1024)])


def _walk_pointnet_sem_seg_head(w: _Walker):
    w.dense("conv1", ("head_mlp", "dense_0"), "conv1",
            perm=_SEMSEG_HEAD_PERM)
    w.bn("bn1", ("head_mlp", "bn_0"))
    w.dense("conv2", ("head_mlp", "dense_1"), "conv1")
    w.bn("bn2", ("head_mlp", "bn_1"))
    w.dense("conv3", ("head_mlp", "dense_2"), "conv1")
    w.bn("bn3", ("head_mlp", "bn_2"))
    w.dense("conv4", ("head_out",), "conv1")


_WALKS = {
    "pointnet2_cls_ssg": _walk_pointnet2_cls_ssg,
    # the kNN bonus variant shares the SSG parameter tree: a lineage
    # SSG .pth loads straight into it (grouping is weight-free)
    "pointnet2_cls_knn": _walk_pointnet2_cls_ssg,
    "pointnet2_cls_msg": _walk_pointnet2_cls_msg,
    "pointnet2_sem_seg": _walk_pointnet2_sem_seg,
    "pointnet2_sem_seg_msg": _walk_pointnet2_sem_seg_msg,
    "pointnet2_part_seg_ssg": _walk_pointnet2_part_seg_ssg,
    "pointnet2_part_seg_msg": _walk_pointnet2_part_seg_msg,
    "pointnet_part_seg_lineage": _walk_pointnet_part_seg_lineage,
}

_ENCODER_MODELS = ("pointnet_cls", "pointnet_sem_seg")

SUPPORTED = tuple(_WALKS) + _ENCODER_MODELS


def _template(variables) -> dict:
    """A flax-layout numpy tree: ``variables`` as they are, or a port
    model's tensors (``to_jax_tree``)."""
    if isinstance(variables, nn.Module):
        return to_jax_tree(variables)
    return variables


def _to_plain(tree):
    if hasattr(tree, "items"):
        return {k: _to_plain(v) for k, v in tree.items()}
    return np.asarray(tree)


def _run(model_name, variables, sd, mode):
    variables = _template(variables)
    params = copy.deepcopy(_to_plain(variables["params"]))
    stats = copy.deepcopy(_to_plain(variables.get("batch_stats", {})))
    if model_name in _ENCODER_MODELS:
        # the encoder lives under params["feat"] in the tree
        _walk_encoder(_Walker(params["feat"], stats["feat"], sd, mode))
        w_top = _Walker(params, stats, sd, mode)
        if model_name == "pointnet_cls":
            _walk_pointnet_cls_top(w_top)
        else:
            _walk_pointnet_sem_seg_head(w_top)
    elif model_name in _WALKS:
        _WALKS[model_name](_Walker(params, stats, sd, mode))
    else:
        raise ValueError(
            f"no canonical torch layout for {model_name!r} "
            f"(supported: {SUPPORTED}; the fusion configs have no lineage "
            "layout, and pointnet_part_seg's skip-concat set differs from "
            "the lineage's: use pointnet_part_seg_lineage for canonical "
            "part-seg .pth files)")
    return {"params": params, "batch_stats": stats}


def import_state_dict(model_name: str, variables, sd) -> dict:
    """Canonical torch state_dict -> flax-layout variables (numpy).

    ``variables`` is the template: a flax-layout tree, or a port model
    (``to_jax_tree`` of its tensors); every imported leaf is shape-checked
    against it. Keys of the state dict that the map does not name
    (``num_batches_tracked``) are ignored."""
    return _run(model_name, variables, dict(sd), "import")


def export_state_dict(model_name: str, variables) -> Dict[str, np.ndarray]:
    """Flax-layout variables, or a port model -> canonical torch
    state_dict (numpy values)."""
    sd: Dict[str, np.ndarray] = {}
    _run(model_name, variables, sd, "export")
    return sd


def load_torch_checkpoint(model_name: str, variables, path: str) -> dict:
    """Import a ``.pth`` file saved by the lineage's train scripts: a bare
    state_dict or the ``{"model_state_dict": ...}`` wrapper, with a
    ``module.`` DataParallel prefix stripped. Loaded with
    ``weights_only=True``: tensors and plain dicts only, never an arbitrary
    pickled object."""
    import torch

    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "model_state_dict" in obj:
        obj = obj["model_state_dict"]
    sd = {k[len("module."):] if k.startswith("module.") else k: v
          for k, v in obj.items()}
    return import_state_dict(model_name, variables, sd)


def load_torch_into_model(model_name: str, model: nn.Module,
                          path: str) -> nn.Module:
    """Fill a port model from a lineage ``.pth`` in place."""
    return load_jax_variables(model, load_torch_checkpoint(model_name, model,
                                                           path))
