"""RF impairment models: IQ imbalance, phase noise, DAC/ADC quantization.

Reference parity: openair1/SIMULATION/RF/rf.c (rf_rx gain/phase noise),
adc.c / dac.c (quantization to B bits), and dlsim's IQ-imbalance injection
(`iqim` term on the Q rail, dlsim.c:2858-2866).

All impairments are elementwise maps over the time-domain waveform,
batched over trials as elementwise work.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp


def iq_imbalance(t, iqim: float):
    """dlsim's model: Q rail picks up iqim * I (dlsim.c:2864)."""
    return t.real + 1j * (t.imag + iqim * t.real)


def iq_imbalance_full(t, amp_db: float = 0.0, phase_deg: float = 0.0):
    """General TX IQ imbalance: y = a*x + b*conj(x) with
    a = (1 + g e^{j phi})/2, b = (1 - g e^{j phi})/2."""
    g = 10.0 ** (amp_db / 20.0)
    phi = np.deg2rad(phase_deg)
    a = 0.5 * (1.0 + g * np.exp(1j * phi))
    b = 0.5 * (1.0 - g * np.exp(1j * phi))
    return a * t + b * jnp.conj(t)


def phase_noise(key, t, linewidth_hz: float, sample_rate_hz: float):
    """Wiener phase noise: random-walk phase with per-sample variance
    2*pi*linewidth/fs (free-running oscillator model)."""
    B, L = t.shape
    var = 2.0 * np.pi * linewidth_hz / sample_rate_hz
    steps = jax.random.normal(key, (B, L)) * jnp.sqrt(var)
    phi = jnp.cumsum(steps, axis=-1)
    return t * jnp.exp(1j * phi)


def dac(t, n_bits: int = 12, full_scale: float = 4.0):
    """Quantize I/Q to n_bits over [-full_scale, +full_scale] (dac.c)."""
    q = full_scale / (1 << (n_bits - 1))

    def _q(x):
        return jnp.clip(jnp.round(x / q), -(1 << (n_bits - 1)),
                        (1 << (n_bits - 1)) - 1) * q
    return _q(t.real) + 1j * _q(t.imag)


adc = dac   # same model on the receive side (adc.c)


def cfo(t, cfo_scs: float, n_fft: int):
    """Carrier frequency offset of `cfo_scs` subcarrier spacings."""
    L = t.shape[-1]
    ph = jnp.exp(2j * np.pi * cfo_scs / n_fft * jnp.arange(L))
    return t * ph
