"""Structured metrics logging.

Counterpart of ``dominantsparseeigenad_tpu/utils/logging.py``: one JSON
record a line, ``{"t": <unix time>, "event": ..., <fields>}``, with
tensors and arrays as (nested) lists.  Metrics stay tensors while the
solvers run (``dominant_eigh(..., with_info=True)``, ``utils.diagnostics``)
and are logged on the host afterwards.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch


def _plain(v):
    """A tensor (on any device, of any dtype, bfloat16 included) or array
    as a Python number or nested list; anything else unchanged."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().tolist()
    if hasattr(v, "tolist"):
        return np.asarray(v).tolist()
    return v


class JsonlLogger:
    """Append-only JSONL metrics log (a file, or stderr with no path)."""

    def __init__(self, path: str | None = None):
        self._fh = open(path, "a") if path else sys.stderr
        self._owns = path is not None

    def log(self, event: str, **fields):
        rec = {"t": time.time(), "event": event}
        rec.update((k, _plain(v)) for k, v in fields.items())
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()

    def close(self):
        if self._owns:
            self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
