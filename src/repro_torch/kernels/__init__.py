"""Hand-written CUDA kernels of the port (``csrc/``), their build, their
plain-PyTorch versions and the wrappers that dispatch between them."""
