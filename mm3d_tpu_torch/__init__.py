"""mm3d_tpu_torch -- the PyTorch/CUDA port of ``mm3d_tpu`` for the H100.

A second package beside the JAX reference. It imports torch and numpy only,
never jax, flax or anything of ``mm3d_tpu``; the tests hold each of its
modules against its JAX twin on the same inputs and weights.

Layout (mirrors ``mm3d_tpu``)
-----------------------------
ops/       plain PyTorch geometry ops, kernel wrappers, dispatch, kernel build
csrc/      hand-written CUDA kernels for sm_90a (FPS, ball query, fused SA)
models/    nn.Modules: layers, SetAbstraction, image CNN, fusion_cls, registry
training/  serving entry point (``make_predictor``)
utils/     flax-variables import (``load_jax_variables``)

This slice serves the ``fusion_cls`` eval forward. Entry points run on the
card unless the caller asks for the CPU.
"""

__version__ = "0.1.0"
