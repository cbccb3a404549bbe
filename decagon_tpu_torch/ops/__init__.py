"""Aggregation and scoring ops: plain PyTorch versions and CUDA kernels."""
