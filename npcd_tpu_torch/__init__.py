"""PyTorch + CUDA port of npcd_tpu: the generation path (DDPM sampler ->
PointNeRF render) and stage-2 training of the denoiser, exact f32. Imports
torch and numpy, never JAX; the kernels of both paths are built from
``csrc/`` (CUDA C++) or written in Triton, and each has a plain PyTorch
version that CPU tensors take."""
