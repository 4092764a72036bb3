"""Hand-written CUDA kernels of the port, their build, and their plain PyTorch versions."""
