"""Timing drift tracking, AGC, and pilot-based frequency tracking.

Reference parity: openair1/PHY/LTE_ESTIMATION/lte_adjust_sync.c
(lte_adjust_synch — early/late gate on the channel impulse response energy,
nudging rx_offset), adjust_gain.c (phy_adjust_gain — RSSI-driven gain
target), lte_est_freq_offset.c (phase of the cross-correlation of channel
estimates between pilot symbols).

All three are small reductions over tensors the receiver
already has (channel estimates / received grids), batched over trials.
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp


def timing_gate(H_freq, cp_len: int, n_fft: int):
    """Early/late timing gate from a frequency-domain channel estimate.

    H_freq [B, M] (estimate over M contiguous subcarriers). Returns
    offset_samples [B] (positive => impulse response arrives late => advance
    rx_offset), computed like the reference: IDFT to the delay domain,
    compare energy in the early window vs the late window around the CP.
    """
    g = jnp.fft.ifft(H_freq, axis=-1)
    M = H_freq.shape[-1]
    p = jnp.abs(g) ** 2
    # delay-domain bin resolution: n_fft / M samples per bin
    w = max(1, int(round(cp_len * M / n_fft / 2)))
    early = jnp.sum(p[..., :w], axis=-1)
    late = jnp.sum(p[..., M - w:], axis=-1)      # negative delays (early FFT)
    # centroid of the main energy: signed sample offset
    k = jnp.concatenate([jnp.arange(0, M // 2), jnp.arange(-M // 2, 0)])
    cent = jnp.sum(p * k, axis=-1) / jnp.maximum(jnp.sum(p, axis=-1), 1e-12)
    offset = cent * n_fft / M
    gate = jnp.sign(late - early)
    return offset, gate


def track_timing(rx_offset, offset_est, step: int = 1, deadzone: float = 0.5):
    """One tracking update: move rx_offset by +-step when the estimated
    offset leaves the deadzone (the reference adjusts by 1 sample/frame)."""
    adj = jnp.where(offset_est > deadzone, step,
                    jnp.where(offset_est < -deadzone, -step, 0))
    return rx_offset + adj


def agc_gain(rssi_per_sc, target: float = 1.0):
    """phy_adjust_gain: linear gain g so that g^2 * RSSI == target."""
    return jnp.sqrt(target / jnp.maximum(rssi_per_sc, 1e-12))


def pilot_cfo_estimate(h_p0, h_p1, symbol_distance: int, n_fft: int,
                       cp: int):
    """Residual CFO from channel estimates at two pilot symbols.

    h_p0/h_p1 [B, M]: estimates at pilot symbols `symbol_distance` OFDM
    symbols apart. Returns CFO in subcarrier spacings (lte_est_freq_offset's
    cross-correlation phase)."""
    x = jnp.sum(h_p1 * jnp.conj(h_p0), axis=-1)
    dt = symbol_distance * (n_fft + cp)          # samples between pilots
    return jnp.angle(x) / (2.0 * np.pi) * n_fft / dt
