"""Hand-written CUDA kernels with their wrappers and plain PyTorch versions."""
