"""The kernels: CUDA C++ for sm_90a under ``csrc/``, each with its wrapper
and its plain PyTorch version (see ``ops``)."""
