"""Hand-written Hopper kernels (CUDA C++ for sm_90a), one folder each:
``<name>.cu`` (built on first use by :mod:`._build`), ``ops.py`` (the
wrappers: the kernel for GPU tensors, the plain version for CPU tensors)
and ``ref.py`` (the plain PyTorch version)."""
