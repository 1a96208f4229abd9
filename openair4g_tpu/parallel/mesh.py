"""Device mesh construction for the Monte-Carlo / streaming axes.

Reference parity: the reference's distributed axes (SURVEY.md §2.12) — oaisim
-M multicast data-parallelism over UE/channel instances (P4) and the
subframe sample-stream pipeline (P2) — map to a JAX mesh with axes:

  * "ue": data parallel over UE channels / Monte-Carlo trials (DP)
  * "t":  context parallel over time blocks of the sample stream (SP),
          halo = cyclic prefix / correlation tail via ppermute

On one host this is the local device list; under jax.distributed the same
code spans hosts (NVLink within a host, the network across)."""
from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh


def make_mesh(n_ue: int | None = None, n_t: int = 1) -> Mesh:
    """Mesh over (ue, t). Defaults to all devices on the ue axis."""
    devs = jax.devices()
    if n_ue is None:
        n_ue = len(devs) // n_t
    n = n_ue * n_t
    if n > len(devs):
        raise ValueError(f"need {n} devices, have {len(devs)}")
    arr = np.array(devs[:n]).reshape(n_ue, n_t)
    return Mesh(arr, axis_names=("ue", "t"))
