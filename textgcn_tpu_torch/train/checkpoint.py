"""Model checkpoints: parameters, optimizer state and training metadata.

Port of ``textgcn_tpu/train/checkpoint.py`` (``save_checkpoint``,
``restore_checkpoint``). The JAX package writes an Orbax directory; the port
writes a directory too, holding one ``torch.save`` file, and reads it back
with ``torch.load(..., weights_only=True)``, so a checkpoint carries tensors
and plain values only, never code. Every tensor is stored on the CPU, so a
checkpoint written on the card loads on the CPU and back.

Reading the JAX package's Orbax checkpoints is out of scope: the port has
neither Orbax nor JAX (parameters cross from JAX with
:func:`textgcn_tpu_torch.models.family.params_from_jax` instead).
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional

import torch

FILE = "checkpoint.pt"


def _to_cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def save_checkpoint(
    path: str,
    params: Dict[str, torch.Tensor],
    opt_state: Optional[Dict[str, Any]] = None,
    metadata: Optional[Dict[str, Any]] = None,
    **extra: Any,
) -> str:
    """Write ``{"params", "opt_state", "metadata", **extra}`` into the
    directory ``path`` (created, or overwritten, as Orbax's ``force=True``
    does); returns its absolute path. The file is written under a temporary
    name and renamed, so an interrupted save leaves no half-written
    checkpoint."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    state = {"params": params}
    if opt_state is not None:
        state["opt_state"] = opt_state
    if metadata:
        state["metadata"] = dict(metadata)
    state.update(extra)
    tmp = os.path.join(path, FILE + ".tmp")
    torch.save(_to_cpu(state), tmp)
    os.replace(tmp, os.path.join(path, FILE))
    return path


def restore_checkpoint(path: str) -> Dict[str, Any]:
    """Read a checkpoint written by :func:`save_checkpoint` (tensors on the
    CPU)."""
    file = os.path.join(os.path.abspath(path), FILE)
    if not os.path.exists(file):
        raise FileNotFoundError(f"no checkpoint at {path} (expected {file})")
    return torch.load(file, map_location="cpu", weights_only=True)
