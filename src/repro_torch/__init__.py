"""PyTorch + CUDA port of the VitaLLM serving stack (BitNet b1.58 main path;
the dense and moe families).

The package mirrors the JAX reference's layout (``configs/``, ``core/``,
``kernels/``, ``models/``, ``serving/``, ``distributed/``, ``launch/``).
Plain tensor code is PyTorch; the five kernels of the serving path (TINT
projection, whole FFN,
chunked-prefill attention, LOP-sparse and dense decode attention; the
projection and the FFN also in their expert-stacked form) are
hand-written CUDA C++ under ``csrc/``, built with ``nvcc`` at first use
and bound with ``ctypes``. Each kernel keeps a plain PyTorch version beside it, which a
wrapper takes only for tensors on the CPU.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no card and no explicit CPU request they raise.
"""

from repro_torch.device import resolve_device  # noqa: F401
