"""Attention, kNN and the kernels of the port."""
