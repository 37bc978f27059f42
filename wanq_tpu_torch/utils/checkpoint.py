"""Checkpoint save / load of training state (counterpart of
wanq_tpu/utils/checkpoint.py): a tree of tensors (an optimizer's state
dict) through ``torch.save`` and ``torch.load(weights_only=True)``.
``wanq_tpu`` writes orbax directories instead, so these files do not cross
between the packages (the adapters do, as the npz of
``training/lora.py::save_lora``)."""

from __future__ import annotations

import os
from typing import Any, Optional

import torch


def save_checkpoint(path: str, tree: Any) -> str:
    """Save a tree of tensors, or anything with a ``state_dict()`` (an
    optimizer), to ``path``."""
    path = os.path.abspath(path)
    torch.save(tree.state_dict() if hasattr(tree, "state_dict") else tree, path)
    return path


def load_checkpoint(path: str, target: Optional[Any] = None, device=None) -> Any:
    """The saved tree (on ``device``, or where it was saved); loaded into
    ``target`` (anything with ``load_state_dict``, an optimizer) and
    ``target`` returned when given."""
    tree = torch.load(os.path.abspath(path), map_location=device, weights_only=True)
    if target is None:
        return tree
    target.load_state_dict(tree)
    return target
