"""Carry the JAX package's parameters and KV caches into the port.

Inputs are numpy arrays (``np.asarray`` of each JAX leaf), so this module
needs no JAX.  The nested-dict layout is kept as it is: ``(in, out)``
weight matrices and layers stacked on axis 0.  ``torch.from_numpy``
rejects ``ml_dtypes.bfloat16``, so bf16 leaves come through float32
(exact) and are cast back.  A ``QTensor`` crosses as the numpy pair
``(q, exp)`` (:func:`resnet_params_from_jax`, :func:`to_numpy`).
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.quant import QTensor


def _is_bf16(a: np.ndarray) -> bool:
    return a.dtype.name == "bfloat16"


def to_torch(a: Any, device=None, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """One numpy (or array-like) leaf -> tensor, bf16 kept as bf16."""
    a = np.asarray(a)
    if _is_bf16(a):
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))      # a writable copy
    if dtype is not None:
        t = t.to(dtype)
    return t.to(device) if device is not None else t


def from_jax(tree: Any, device=None, dtype: Optional[torch.dtype] = None) -> Any:
    """Convert a (nested dict / tuple / list) tree of numpy leaves."""
    if isinstance(tree, dict):
        return {k: from_jax(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(from_jax(v, device, dtype) for v in tree)
    if tree is None:
        return None
    return to_torch(tree, device, dtype)


def to_numpy(tree: Any) -> Any:
    """The way back, for round trips: tensors -> float32/int numpy arrays
    (bf16 comes out as float32), a ``QTensor`` -> ``(q, exp)``."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_numpy(v) for v in tree)
    if tree is None:
        return None
    if isinstance(tree, QTensor):
        return (to_numpy(tree.q), to_numpy(tree.exp))
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.numpy()


def cache_from_jax(cache: Any, device=None) -> tuple:
    """A JAX KV cache -> tensors: ``(k, v)`` of (L, B, S, KV, hd) arrays,
    or a ``kv_quant`` cache's four leaves, int8 payloads and their
    (L, B, S, KV) int8 exponents, dtypes kept."""
    return tuple(to_torch(c, device) for c in cache)


def resnet_params_from_jax(params_np: dict, device=None) -> dict:
    """A JAX ResNet parameter tree (``repro.models.resnet.init_params``)
    -> the port's, with each ``QTensor`` leaf given as numpy ``(q, exp)``:
    ``{layer: {"w": (q, exp), "bias": ..., "shift": ...}}``."""
    out = {}
    for name, layer in params_np.items():
        q, exp = layer["w"]
        out[name] = {
            "w": QTensor(q=to_torch(q, device, torch.int8), exp=to_torch(exp, device, torch.int32)),
            "bias": to_torch(layer["bias"], device, torch.int32),
            "shift": to_torch(layer["shift"], device, torch.int32),
        }
    return out
