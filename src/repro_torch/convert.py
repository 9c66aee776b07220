"""Carry a quantized serving tree between numpy and the port, bitwise.

``from_numpy_tree`` takes the reference's quantized serving tree as a
nested dict of numpy arrays (uint8 codes, f32 γ rows, norms, embedding,
head) and returns the same tree of torch tensors on ``device``; every
leaf keeps its dtype, shape and bytes.
"""

from __future__ import annotations

import numpy as np
import torch


def from_numpy_tree(tree, device) -> dict:
    if isinstance(tree, dict):
        return {k: from_numpy_tree(v, device) for k, v in tree.items()}
    arr = np.ascontiguousarray(np.asarray(tree))
    return torch.from_numpy(arr.copy()).to(device)

