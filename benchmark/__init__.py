"""The benchmark of the PyTorch and CUDA port (storygen_tpu_torch): see
README.md."""
