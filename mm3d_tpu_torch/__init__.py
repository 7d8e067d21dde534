"""mm3d_tpu_torch -- the PyTorch/CUDA port of ``mm3d_tpu`` for the H100.

A second package beside the JAX reference. It imports torch and numpy only,
never jax, flax or anything of ``mm3d_tpu``; the tests hold each of its
modules against its JAX twin on the same inputs and weights.

Layout (mirrors ``mm3d_tpu``)
-----------------------------
ops/       plain PyTorch geometry ops, kernel wrappers, dispatch, kernel build
csrc/      hand-written CUDA kernels for sm_90a (FPS, ball query, fused SA,
           gather backward, fused FP tail, bilinear image sampling)
models/    nn.Modules: layers, SetAbstraction, FeaturePropagation, image CNN,
           fusion_cls, fusion_sem_seg, losses, registry
data/      synthetic datasets, augmentation, the prefetching input pipeline
training/  serving (``make_predictor``) and training (``Trainer``, steps,
           optimizer, schedules)
utils/     flax weight transfer, metrics, profiling on the card

The port serves and trains ``fusion_cls`` and serves ``fusion_sem_seg``.
Entry points run on the card unless the caller asks for the CPU.
"""

__version__ = "0.3.0"
