"""L0 geometry ops of the PyTorch/CUDA port.

`geometry` holds the plain PyTorch versions (run anywhere) and the gather
whose backward is the gather-backward kernel; `cuda_kernels`
holds the wrappers of the hand-written Hopper kernels in ``csrc/``, which
take the plain version only for CPU tensors or under ``use_impl("torch")``;
`projection` the point->pixel projection and image sampling;
`dispatch` holds the mode switch.
"""

from mm3d_tpu_torch.ops import projection
from mm3d_tpu_torch.ops.cuda_kernels import (bilinear_sample,
                                             bilinear_sample_torch,
                                             farthest_point_sample, fused_fp,
                                             fused_fp_torch, fused_sa,
                                             fused_sa_torch, gather_backward,
                                             gather_backward_torch,
                                             query_ball_point)
from mm3d_tpu_torch.ops.dispatch import get_impl, set_impl, use_impl
from mm3d_tpu_torch.ops.geometry import (ball_query_torch, fps_torch,
                                         index_points, interpolation_weights,
                                         sample_and_group_all,
                                         square_distance, three_interpolate,
                                         three_interpolate_torch, three_nn,
                                         three_nn_torch)

__all__ = [
    "square_distance",
    "index_points",
    "farthest_point_sample",
    "query_ball_point",
    "fused_sa",
    "gather_backward",
    "gather_backward_torch",
    "sample_and_group_all",
    "fps_torch",
    "ball_query_torch",
    "fused_sa_torch",
    "fused_fp",
    "fused_fp_torch",
    "bilinear_sample",
    "bilinear_sample_torch",
    "three_nn",
    "three_nn_torch",
    "interpolation_weights",
    "three_interpolate",
    "three_interpolate_torch",
    "projection",
    "set_impl",
    "get_impl",
    "use_impl",
]
