"""Checkpointing: flat-key .npz save/restore of nested dicts, tuples and
NamedTuples of tensors."""

from .checkpoint import latest_step, restore, save

__all__ = ["save", "restore", "latest_step"]
