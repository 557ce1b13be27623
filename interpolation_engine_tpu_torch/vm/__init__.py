"""Batched device VM on PyTorch: the turbo engine and its entry point."""
