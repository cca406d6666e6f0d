"""repro_torch: the PyTorch/CUDA port of :mod:`repro` for one NVIDIA H100.

It mirrors the JAX package module for module (``repro/core/packing.py``
-> ``repro_torch/core/packing.py``) and runs the paper's main path —
LeNet on procedural MNIST, trained with momentum SGD and LARS — with the
packed LARS step's two memory-bound passes in hand-written CUDA kernels
(:mod:`repro_torch.kernels.lars_kernels`). It imports ``torch`` and
never ``jax`` or anything of ``repro``.
"""

__version__ = "0.1.0"
