"""Utilities of the port: checkpointing (``checkpoint.py``)."""

from .checkpoint import load_orbax, load_pytree, save_orbax, save_pytree

__all__ = ["load_orbax", "load_pytree", "save_orbax", "save_pytree"]
