"""PyTorch / CUDA port of surreal_tpu for one NVIDIA H100.

The JAX package `surreal_tpu` is the reference; this package mirrors its
layout so each module has a named counterpart. It imports torch and numpy
only (never jax, flax, optax or surreal_tpu) and reads the baked physics
assets of `surreal_tpu/envs/assets/` in place as data files.

Entry points run on "cuda" unless the caller passes `device="cpu"`; there
is no silent CPU fallback (see `device.resolve`).
"""
