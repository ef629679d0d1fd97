"""Attention ops: plain PyTorch math and the hand-written CUDA kernels."""
