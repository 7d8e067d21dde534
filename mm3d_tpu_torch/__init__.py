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
data/      synthetic datasets, augmentation, the prefetching input pipeline
training/  serving (``make_predictor``, ``export_serving``) and training
           (``Trainer``, steps, optimizer, schedules)
serving.py the HTTP daemon of exported artifacts (``PredictionService``,
           ``make_server``; ``python -m mm3d_tpu_torch.serving``)
utils/     flax weight transfer, metrics, profiling on the card

The port serves and trains every model of the JAX registry: the five
BASELINE configs (PointNet, config 1; the PointNet++ classifier, config 2;
PointNet++ part segmentation, config 3; ``fusion_cls``, config 4;
``fusion_sem_seg``, config 5) and the other ten entries.
Entry points run on the card unless the caller asks for the CPU.
"""

__version__ = "0.3.0"
