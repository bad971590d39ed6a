"""StoryGen in PyTorch with hand-written CUDA kernels for Hopper (sm_90a).

The counterpart of `storygen_tpu` (JAX/Flax with Pallas TPU kernels),
module for module: `checkpoint/`, `diffusion/`, `ops/`, `models/` and
`pipeline.py`. Tensors keep the JAX package's NHWC layout at every public
function, and parameter names are the diffusers ones. This package imports
`torch` and never `jax` or `flax`; it shares only `storygen_tpu.configs`,
which imports the standard library alone.
"""
