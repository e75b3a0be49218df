from .convert import load_jax_buffers, load_jax_params

__all__ = ["load_jax_params", "load_jax_buffers"]
