"""Kernels of the serving path: CUDA sources in ``csrc/``, their ctypes
wrappers, their plain PyTorch versions (``ref``), and the device-dispatching
entry points (``ops``)."""
