"""Turbo decoder settings per JAX backend, in one table.

The windowed max-log-MAP decoder (ops/turbo.py) has a few free
parameters that do not change what it computes beyond the window-edge
approximation, only how fast it runs on a given device:

  window      W: trellis steps per window (more windows = more parallel
              lanes, but more warm-up work per decoded bit)
  warmup      U: warm-up steps seeded from the neighbouring window
  unroll      trellis steps per `lax.scan` iteration of the XLA path
  half_iter   "xla" (the `lax.scan` of ops/turbo._half_iteration) or
              "triton" (the Pallas kernel of ops/turbo_pallas.py)
  lanes       windows per kernel block (Triton route only)

"cpu" is what the test suite runs. "gpu" was chosen by a sweep of the
20 MHz MCS26 flagship step on one H100 (PERF.md, "Bring-up on the
H100"). Any other backend has no measured settings and is refused.
"""
from __future__ import annotations

from dataclasses import dataclass

import jax


@dataclass(frozen=True)
class DecoderSettings:
    window: int
    warmup: int
    unroll: int
    half_iter: str = "xla"
    lanes: int = 128


DECODER_SETTINGS = {
    "cpu": DecoderSettings(window=96, warmup=24, unroll=2),
    "gpu": DecoderSettings(window=64, warmup=24, unroll=8,
                           half_iter="triton", lanes=128),
}


def decoder_settings(platform: str | None = None) -> DecoderSettings:
    """Settings for `platform` (default: jax.default_backend())."""
    platform = platform or jax.default_backend()
    try:
        return DECODER_SETTINGS[platform]
    except KeyError:
        raise ValueError(
            f"no turbo decoder settings for backend {platform!r}; "
            f"known: {sorted(DECODER_SETTINGS)}") from None
