"""Multi-layer detection: MMSE-IRC per-RE equalizer and exact dual-stream
interference-aware max-log LLRs.

Reference parity: openair1/PHY/LTE_TRANSPORT/dlsch_demodulation.c —
channel compensation per TM (:801, TM3 :1846, TM5/6 :1466),
dlsch_dual_stream_correlation :2477 (rho for interference-aware LLRs),
dlsch_detection_mrc :2583; dlsch_llr_computation.c's nine dual-stream
variants (qam16_qam16 ... qam64_qam64 :983-8401).

The reference hand-writes one SIMD kernel per (Qm0, Qm1)
pair. Here ONE parameterized routine covers all pairs: the exact max-log
bit LLR marginalizing the interfering layer is a max-reduction over the
joint constellation table [2^Qm0 * 2^Qm1] — an einsum + max as elementwise work,
identical math for every modulation pair. The per-RE 2x2 MMSE-IRC solve
is closed-form (no linalg.inv), everything batched over REs.
"""
from __future__ import annotations

import functools

import numpy as np
import jax.numpy as jnp

from ..tables.modulation import mod_table

_EPS = 1e-12


def mmse_detect(y, He, n0):
    """Per-RE unbiased MMSE for L=2 layers, any R >= L.

    y [B, N, R], He [B, N, R, L=2], n0 scalar noise variance.
    Returns (x_hat [B, N, 2] unit-gain symbol estimates,
             n0_eff [B, N, 2] post-equalization effective noise variance,
             including residual inter-layer interference).
    """
    h0 = He[..., 0]
    h1 = He[..., 1]
    a = jnp.sum(jnp.abs(h0) ** 2, -1) + n0          # [B, N]
    d = jnp.sum(jnp.abs(h1) ** 2, -1) + n0
    b = jnp.sum(jnp.conj(h0) * h1, -1)
    det = a * d - jnp.abs(b) ** 2 + _EPS
    # G = (He^H He + n0 I)^-1 He^H ;  rows of the 2x2 inverse:
    z0 = jnp.sum(jnp.conj(h0) * y, -1)              # matched filter outputs
    z1 = jnp.sum(jnp.conj(h1) * y, -1)
    x0 = (d * z0 - b * z1) / det
    x1 = (a * z1 - jnp.conj(b) * z0) / det
    # bias mu_l = [G He]_ll ; unbiased estimate x_l / mu_l,
    # SINR_l = mu_l / (1 - mu_l)
    g00 = (d * (a - n0) - jnp.abs(b) ** 2) / det    # [G He]_00 (real)
    g11 = (a * (d - n0) - jnp.abs(b) ** 2) / det
    mu0 = jnp.clip(g00.real, _EPS, 1.0 - 1e-6)
    mu1 = jnp.clip(g11.real, _EPS, 1.0 - 1e-6)
    x_hat = jnp.stack([x0 / mu0, x1 / mu1], axis=-1)
    n0_eff = jnp.stack([(1.0 - mu0) / mu0, (1.0 - mu1) / mu1], axis=-1)
    return x_hat, n0_eff


@functools.lru_cache(maxsize=None)
def _joint_tables(qm0: int, qm1: int):
    """Joint constellation (s0, s1) tables and the bit masks of layer 0.

    Returns (s0 [J], s1 [J], bit0 [qm0, J]) with J = 2^qm0 * 2^qm1."""
    t0 = mod_table(qm0)
    t1 = mod_table(qm1)
    i0 = np.repeat(np.arange(1 << qm0), 1 << qm1)
    i1 = np.tile(np.arange(1 << qm1), 1 << qm0)
    s0 = t0[i0].astype(np.complex64)
    s1 = t1[i1].astype(np.complex64)
    bit0 = ((i0[None, :] >> (qm0 - 1 - np.arange(qm0)[:, None])) & 1
            ).astype(np.int8)
    return s0, s1, bit0


def dual_stream_llr(z0, rho, g0, n0, qm0: int, qm1: int, chunk: int = 512):
    """Exact max-log LLRs for layer 0 with layer 1 as a constellation-
    constrained interferer (the reference's qamA_qamB kernels).

    Model after matched filtering with h0: z0 = g0*s0 + rho*s1 + w,
    w ~ CN(0, g0*n0), where g0 = |h0|^2 (MRC-summed) and
    rho = h0^H h1 (dlsch_dual_stream_correlation).

    z0, rho, g0: [B, N] (complex, complex, real). Returns [B, N, qm0].
    Chunked over N to bound the [*, J] joint-metric tensor.
    """
    s0, s1, bit0 = _joint_tables(qm0, qm1)
    s0 = jnp.asarray(s0)
    s1 = jnp.asarray(s1)
    mask0 = jnp.asarray(bit0 == 0)                   # [qm0, J]
    B, N = z0.shape

    def _block(z0b, rhob, g0b):
        mean = g0b[..., None] * s0 + rhob[..., None] * s1      # [B, n, J]
        d2 = jnp.abs(z0b[..., None] - mean) ** 2
        metric = -d2 / (jnp.maximum(g0b, _EPS) * n0)[..., None]
        m0 = jnp.max(jnp.where(mask0[:, None, None, :],
                               metric[None], -jnp.inf), axis=-1)
        m1 = jnp.max(jnp.where(~mask0[:, None, None, :],
                               metric[None], -jnp.inf), axis=-1)
        return jnp.moveaxis(m0 - m1, 0, -1)                    # [B, n, qm0]

    outs = []
    for start in range(0, N, chunk):
        end = min(start + chunk, N)
        outs.append(_block(z0[:, start:end], rho[:, start:end],
                           g0[:, start:end]))
    return jnp.concatenate(outs, axis=1)


def mf_dual_stream(y, He):
    """Matched-filter front end for dual_stream_llr.

    y [B, N, R], He [B, N, R, 2] -> per layer l: (z_l = h_l^H y,
    g_l = |h_l|^2, rho_l = h_l^H h_other), each [B, N]."""
    h0 = He[..., 0]
    h1 = He[..., 1]
    z0 = jnp.sum(jnp.conj(h0) * y, -1)
    z1 = jnp.sum(jnp.conj(h1) * y, -1)
    g0 = jnp.sum(jnp.abs(h0) ** 2, -1)
    g1 = jnp.sum(jnp.abs(h1) ** 2, -1)
    rho01 = jnp.sum(jnp.conj(h0) * h1, -1)
    return (z0, g0, rho01), (z1, g1, jnp.conj(rho01))
