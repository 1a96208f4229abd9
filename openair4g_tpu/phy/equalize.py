"""Channel compensation / equalization for the inner receiver.

Reference parity: openair1/PHY/LTE_TRANSPORT/dlsch_demodulation.c:801
(dlsch_channel_compensation: matched filter y*conj(h) with channel-magnitude
LLR scaling, MRC :2583) and LTE_ESTIMATION/freq_equalization.c (UL MMSE LUT).

Per-RE ZF with exact effective-noise tracking — equivalent to the
reference's MF + ch_mag LLR scaling but in one normalized form:
    x_hat = y * conj(H) / |H|^2,   N0_eff = N0 / |H|^2
feeding the exact max-log demapper (ops/llr.py). MRC across RX antennas sums
conj(H_a) y_a and |H_a|^2 before the division.
"""
from __future__ import annotations

import jax.numpy as jnp

_EPS = 1e-12


def zf_equalize(y, H, n0):
    """y, H: [...] complex (same shape). Returns (x_hat, n0_eff)."""
    h2 = jnp.maximum((H * jnp.conj(H)).real, _EPS)
    x_hat = y * jnp.conj(H) / h2
    return x_hat, n0 / h2


def mrc_equalize(y, H, n0):
    """y, H: [..., n_rx] complex. MRC combine then normalize.

    Returns (x_hat, n0_eff) with n0_eff = N0 / sum_a |H_a|^2.
    """
    num = jnp.sum(y * jnp.conj(H), axis=-1)
    h2 = jnp.maximum(jnp.sum((H * jnp.conj(H)).real, axis=-1), _EPS)
    return num / h2, n0 / h2
