"""Device kernels: hand-written CUDA beside their plain PyTorch versions."""
