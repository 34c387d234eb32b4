"""Tensor operations of the port: plain PyTorch code and the CUDA kernels."""
