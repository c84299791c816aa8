"""Ops with a hand-written CUDA kernel and a plain PyTorch version each."""
