"""Utilities of the port: flax weight transfer, metrics, profiling."""

from mm3d_tpu_torch.utils.jax_import import (flax_names, load_jax_variables,
                                             to_jax_tree)

__all__ = ["load_jax_variables", "flax_names", "to_jax_tree"]
