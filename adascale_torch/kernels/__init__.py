"""Hand-written CUDA kernels with their plain PyTorch twins."""
