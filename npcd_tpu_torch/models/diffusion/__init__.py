"""Denoiser, DDPM sampler and normalizers."""
