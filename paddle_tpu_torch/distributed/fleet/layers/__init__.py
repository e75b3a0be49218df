"""Tensor-parallel layers (``mpu``)."""
