"""SeTok on PyTorch and CUDA: the port of `setok_tpu` to an NVIDIA H100.

The JAX package `setok_tpu` is the reference this package is held against;
this package imports nothing of it, nor JAX. Entry points run on the card
unless the caller passes `device="cpu"`.
"""
