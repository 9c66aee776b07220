"""Kernels of the port: CUDA sources in ``csrc/``, their ctypes wrappers,
their plain PyTorch versions (``ref``), and the device-dispatching entry
points (``ops``) — the five of the serving path and the four standalone
building blocks (TINT GEMM, LOP screen, flash prefill, block-sparse
decode)."""

from repro_torch.kernels import ops, ref
from repro_torch.kernels.ops import (decode_attention, ffn_fused,
                                     flash_prefill, lop_screen,
                                     prefill_attention, qlinear_fused,
                                     sparse_decode, ternary_matmul)
