"""StoryGen in PyTorch with hand-written CUDA kernels for Hopper (sm_90a).

The counterpart of `storygen_tpu` (JAX/Flax with Pallas TPU kernels),
module for module: `configs.py`, `checkpoint/`, `data/`, `diffusion/`,
`ops/`, `models/`, `training/`, `utils/` and `pipeline.py`. Tensors keep the
JAX package's NHWC layout at every public function, and parameter names are
the diffusers ones. This package imports `torch` and never `jax`, `flax` or
any module of `storygen_tpu`: what it needs from there it keeps as its own
copy (`configs.py`).
"""
