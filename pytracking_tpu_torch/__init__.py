"""pytracking_tpu_torch: the PyTorch/CUDA port of pytracking_tpu for NVIDIA Hopper.

The JAX package `pytracking_tpu` is the reference; this package imports none of
it. Module names mirror the JAX package's, so every file has a counterpart.
"""
