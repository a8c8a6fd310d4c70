"""The check that no JAX module is loaded in the process that reports.

Top-level names are compared whole: the port's name,
``dominantsparseeigenad_tpu_torch``, begins with the JAX package's,
``dominantsparseeigenad_tpu``, and must not match it.
"""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "dominantsparseeigenad_tpu"})


def forbidden_modules(names=None):
    """The loaded modules whose top-level name is forbidden, sorted."""
    names = sys.modules if names is None else names
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
