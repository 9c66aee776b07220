"""Carry a quantized serving tree between numpy and the port, bitwise.

``from_numpy_tree`` takes the reference's quantized serving tree as a
nested dict of numpy arrays (uint8 codes, f32 γ rows, norms, embedding,
head) and returns the same tree of torch tensors on ``device``; every
leaf keeps its dtype, shape and bytes. ``ternary_weight_from_numpy`` does
the same for one packed ternary weight given as (packed, scale, shape).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.ternary import TernaryWeight


def from_numpy_tree(tree, device) -> dict:
    if isinstance(tree, dict):
        return {k: from_numpy_tree(v, device) for k, v in tree.items()}
    arr = np.ascontiguousarray(np.asarray(tree))
    return torch.from_numpy(arr.copy()).to(device)



def ternary_weight_from_numpy(packed, scale, shape, device) -> TernaryWeight:
    """(uint8 codes [k//4, n], f32 γ, (k, n)) → the port's TernaryWeight,
    bitwise. γ is carried across, not recomputed: it is a mean, whose
    last bit depends on the summation order."""
    return TernaryWeight(packed=from_numpy_tree(packed, device),
                         scale=from_numpy_tree(scale, device),
                         shape=tuple(int(s) for s in shape))
