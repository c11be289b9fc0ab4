"""Geometry and feature kernels (JAX, plus one Pallas Triton kernel for the GPU)."""
