"""FPTC in PyTorch: the port of the ``repro`` package to PyTorch and CUDA.

It mirrors ``repro``'s subpackage and module names, so every module has a
reference twin, and imports neither JAX nor ``repro``.  Plain tensor code is
PyTorch; each TPU kernel on a ported path is a hand-written CUDA kernel for
Hopper (``sm_90a``) under ``kernels/csrc/``.  Device entry points run on
the card unless the caller passes ``device="cpu"``.
"""
