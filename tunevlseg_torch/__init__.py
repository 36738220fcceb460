"""PyTorch port of tunevlseg_tpu for NVIDIA Hopper GPUs.

Mirrors the JAX package's layout (models/, nn/, ops/, training/, convert/);
the JAX package stays the numerical reference. Every Pallas TPU kernel on a
ported path is a hand-written CUDA C++ kernel under csrc/, built at first use.
This package imports torch and numpy, never jax.
"""
