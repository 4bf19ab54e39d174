"""PyTorch + CUDA port of npcd_tpu, generation path (DDPM sampler ->
PointNeRF render), forward only. Imports torch and numpy, never JAX; the
kernels of the path are built from ``csrc/`` (CUDA C++) or written in
Triton, and each has a plain PyTorch version that CPU tensors take."""
