"""PyTorch/CUDA port of the SparCE serving system (reference: ``repro``).

Importing the package loads no kernel and touches no device; kernels
build with ``nvcc`` at first use (``repro_torch/kernels/_build.py``).
"""
