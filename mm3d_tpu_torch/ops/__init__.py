"""L0 geometry ops of the PyTorch/CUDA port.

`geometry` holds the plain PyTorch versions (run anywhere) and the gather
whose backward is the gather-backward kernel; `cuda_kernels`
holds the wrappers of the hand-written Hopper kernels in ``csrc/``, which
take the plain version only for CPU tensors or under ``use_impl("torch")``;
`dispatch` holds the mode switch.
"""

from mm3d_tpu_torch.ops.cuda_kernels import (farthest_point_sample, fused_sa,
                                             fused_sa_torch, gather_backward,
                                             gather_backward_torch,
                                             query_ball_point)
from mm3d_tpu_torch.ops.dispatch import get_impl, set_impl, use_impl
from mm3d_tpu_torch.ops.geometry import (ball_query_torch, fps_torch,
                                         index_points, sample_and_group_all,
                                         square_distance)

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
    "set_impl",
    "get_impl",
    "use_impl",
]
