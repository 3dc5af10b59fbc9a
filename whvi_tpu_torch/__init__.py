"""whvi_tpu_torch — Walsh-Hadamard Variational Inference in PyTorch/CUDA.

The PyTorch counterpart of :mod:`whvi_tpu`, laid out module for module
like it (``ops``, ``models``, ``train``). The structured product
``y = s1 * H(u * H(s2 * x))`` and the bare FWHT run as hand-written CUDA
kernels for Hopper (``csrc/``) on CUDA tensors, and as their plain
PyTorch versions on CPU tensors. The JAX package is the reference the
port is tested against; this package never imports it.

Importing this package imports nothing heavy: the kernels are built at
their first launch on a CUDA tensor.
"""

__version__ = "0.1.0"
