"""CUDA kernels, their plain PyTorch versions and the padded wrappers."""
