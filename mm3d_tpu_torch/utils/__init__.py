"""Utilities of the port."""

from mm3d_tpu_torch.utils.jax_import import load_jax_variables

__all__ = ["load_jax_variables"]
