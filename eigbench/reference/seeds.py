"""Seeds derived from a run's ``--seed``: one stream per purpose, so that
the same seed gives the same operator and the same per-solve inputs."""

from __future__ import annotations

import numpy as np
import torch


def sub_seed(seed: int, *keys) -> int:
    """A 63-bit seed for the stream named by ``keys`` under ``seed`` (any
    whole number, also past 32 bits)."""
    words = [int(seed) & 0xFFFFFFFF, (int(seed) >> 32) & 0xFFFFFFFF]
    for key in keys:
        if isinstance(key, str):
            words += list(key.encode())
        else:
            words.append(int(key) & 0xFFFFFFFF)
    state = np.random.SeedSequence(words).generate_state(2, np.uint32)
    return ((int(state[0]) << 32) | int(state[1])) & ((1 << 63) - 1)


def generator(seed: int, *keys, device="cpu") -> torch.Generator:
    """A torch generator on ``device`` seeded for the stream ``keys``."""
    return torch.Generator(device=device).manual_seed(sub_seed(seed, *keys))


def rng(seed: int, *keys) -> np.random.Generator:
    """A numpy generator for the stream ``keys`` (host-side draws)."""
    return np.random.default_rng(sub_seed(seed, *keys))
