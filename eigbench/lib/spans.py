"""The harness's own spans inside a solve: host time between two device
synchronizations, in ms, recorded only in a traced run."""

from __future__ import annotations

import contextlib
import time

import torch


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


@contextlib.contextmanager
def span(spans, name: str, device):
    """Record the block's synced duration under ``name`` in ``spans``
    (a dict); with ``spans`` None the block runs untimed and unsynced."""
    if spans is None:
        yield
        return
    sync(device)
    t0 = time.perf_counter()
    yield
    sync(device)
    spans[name] = (time.perf_counter() - t0) * 1e3
