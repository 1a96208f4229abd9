"""OFDM modulation / demodulation (CP-OFDM), 36.211 §6.12.

Reference parity: openair1/PHY/MODULATION/ofdm_mod.c:85 (PHY_ofdm_mod — IDFT
per symbol + cyclic prefix) and MODULATION/slot_fep.c:37 (CP removal + DFT).

Unitary FFTs batched over (batch, symbol) via XLA's fft — the
per-RE signal/noise calibration is exact under the unitary convention (time
power == frequency power). CP add/remove are static slices/concats. Pallas
DFT kernels can swap in underneath without changing this interface.
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..config import FrameParms


def _cp_lengths(fp: FrameParms) -> np.ndarray:
    cps = []
    for sym in range(fp.symbols_per_subframe):
        l = sym % fp.symbols_per_slot
        cps.append(fp.cp0 if l == 0 else fp.cp)
    return np.asarray(cps, np.int64)


def ofdm_modulate(grid, fp: FrameParms):
    """grid [B, nsym, n_fft] freq -> time [B, samples_per_tti].

    Unitary IFFT per symbol, then per-symbol cyclic prefix prepend.
    """
    x = jnp.fft.ifft(grid, axis=-1, norm="ortho")
    cps = _cp_lengths(fp)
    parts = []
    for sym in range(fp.symbols_per_subframe):
        cp = int(cps[sym])
        s = x[:, sym, :]
        parts.append(jnp.concatenate([s[:, -cp:], s], axis=-1))
    return jnp.concatenate(parts, axis=-1)


def ofdm_modulate_host(grid: np.ndarray, fp: FrameParms) -> np.ndarray:
    """Host (numpy) version of ofdm_modulate, for config-time waveform
    precomputes."""
    x = np.fft.ifft(grid, axis=-1, norm="ortho")
    cps = _cp_lengths(fp)
    parts = []
    for sym in range(fp.symbols_per_subframe):
        cp = int(cps[sym])
        s = x[..., sym, :]
        parts.append(np.concatenate([s[..., -cp:], s], axis=-1))
    return np.concatenate(parts, axis=-1)


def ofdm_demodulate(t, fp: FrameParms):
    """time [B, samples_per_tti] -> grid [B, nsym, n_fft] (unitary FFT)."""
    cps = _cp_lengths(fp)
    offs = 0
    syms = []
    for sym in range(fp.symbols_per_subframe):
        cp = int(cps[sym])
        start = offs + cp
        syms.append(t[:, start:start + fp.n_fft])
        offs = start + fp.n_fft
    x = jnp.stack(syms, axis=1)
    return jnp.fft.fft(x, axis=-1, norm="ortho")
