"""Batched feature kernels over padded ROI tensors (PyTorch + CUDA)."""
