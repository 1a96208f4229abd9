"""Host-side PRNG key construction.

Threefry key material is just a uint32 pair, and distinct key data gives
independent streams, so Monte-Carlo trial keys are built directly in numpy —
deterministic per (seed, index), identical across hosts and platforms, and
with no device work per batch. Splits *inside* jitted steps are unaffected.

Reference parity: the reference seeds its Tausworthe RNG per trial
(SIMULATION/TOOLS/taus.c); here the (seed, trial) pair is the stream id.
"""
from __future__ import annotations

import numpy as np


def host_keys(seed: int, n: int, stream: int = 0) -> np.ndarray:
    """[n, 2] uint32 threefry key data for trials `stream*n .. stream*n+n-1`
    of seed `seed`. Pass straight to a jitted step expecting PRNG keys."""
    hi = np.full(n, np.uint32(seed & 0xFFFFFFFF), np.uint32)
    lo = (np.uint32(stream) * np.uint32(n) + np.arange(n, dtype=np.uint32))
    return np.stack([hi, lo], axis=1)
