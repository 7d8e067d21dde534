"""mm3d_tpu_torch -- the PyTorch/CUDA port of ``mm3d_tpu`` for the H100.

A second package beside the JAX reference. It imports torch and numpy only,
never jax, flax or anything of ``mm3d_tpu``; the tests hold each of its
modules against its JAX twin on the same inputs and weights.

Layout (mirrors ``mm3d_tpu``)
-----------------------------
ops/       plain PyTorch geometry ops, kernel wrappers and the ``mm3d::*``
           kernel operators, dispatch, kernel build
csrc/      hand-written CUDA kernels for sm_90a (FPS, ball query, fused SA,
           gather backward, fused FP tail, bilinear image sampling,
           three_nn, three_interpolate)
models/    nn.Modules: layers, SetAbstraction(Msg), FeaturePropagation, image
           CNN, the PointNet models, the PointNet++ classifiers, part-seg
           and sem-seg models, fusion_cls, fusion_sem_seg, losses, registry
data/      synthetic datasets, augmentation (with the numpy twins
           ``host_np``), the prefetching input pipeline
training/  serving (``make_predictor``, ``export_serving``), training
           (``Trainer``, steps, train state, optimizer, schedules) and
           vote evaluation (``make_vote_*_step``)
serving.py the HTTP daemon of exported artifacts (``PredictionService``,
           ``make_server``; ``python -m mm3d_tpu_torch.serving``)
utils/     flax weight transfer, checkpoints (``CheckpointManager``), the
           run directory and metrics log (``create_run_dir``,
           ``MetricsLogger``), metrics, profiling on the card

The port serves and trains every model of the JAX registry: the five
BASELINE configs (PointNet, config 1; the PointNet++ classifier, config 2;
PointNet++ part segmentation, config 3; ``fusion_cls``, config 4;
``fusion_sem_seg``, config 5) and the other ten entries.
Entry points run on the card unless the caller asks for the CPU. A
``Trainer`` writes its run directory under ``TrainConfig.log_dir`` and, with
``checkpoint`` on, resumes (``resume=True``, ``run_name=...``) bit for bit
on the device type its checkpoint was written on.
"""

__version__ = "0.3.0"

# the entry points, imported on first use: importing the package itself
# stays free of torch, so ``python -m mm3d_tpu_torch.serving`` and the other
# module mains run their module once
_EXPORTS = {
    "mm3d_tpu_torch.training": (
        "make_predictor", "agreement", "TrainConfig", "Trainer",
        "make_vote_eval_step", "make_vote_partseg_step",
        "make_vote_fusion_cls_step", "make_vote_fusion_semseg_step",
        "draw_vote_angles", "draw_vote_perms"),
    "mm3d_tpu_torch.utils": ("CheckpointManager", "MetricsLogger",
                             "create_run_dir"),
}
__all__ = [name for names in _EXPORTS.values() for name in names]


def __getattr__(name):
    for module, names in _EXPORTS.items():
        if name in names:
            import importlib
            return getattr(importlib.import_module(module), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
