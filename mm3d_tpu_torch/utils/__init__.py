"""Utilities of the port: flax weight transfer, checkpoints, the run
directory and metrics logger, metrics, profiling."""

from mm3d_tpu_torch.utils.checkpoint import CheckpointManager
from mm3d_tpu_torch.utils.jax_import import (flax_names, load_jax_variables,
                                             to_jax_tree)
from mm3d_tpu_torch.utils.logging_utils import MetricsLogger, create_run_dir

__all__ = ["load_jax_variables", "flax_names", "to_jax_tree",
           "CheckpointManager", "MetricsLogger", "create_run_dir"]
