"""MRC channel compensation + equalization + max-log LLR demap in one form.

Reference parity: openair1/PHY/LTE_TRANSPORT/dlsch_demodulation.c
(dlsch_channel_compensation :801 -> dlsch_detection_mrc :2583 -> LLR
dispatch), three separate SIMD passes in the reference. Here:

    num   = sum_a y_a * conj(h_a)          (MRC numerator)
    h2    = sum_a |h_a|^2                  (MRC gain)
    metric(l) = -(num - l*h2)^2 / (h2*n0)  per PAM level l
    llr_b = max_{l: bit_b(l)=0} metric - max_{l: bit_b(l)=1} metric

The identity -(num/h2 - l)^2 * h2/n0 = -(num - l*h2)^2/(h2*n0) means the
equalized symbol num/h2 and the effective noise n0/h2 are never formed.
It is elementwise work plus a max over at most 8 PAM levels, which XLA
fuses by itself; phy/equalize.mrc_equalize followed by ops/llr.demap_llr
is the two-stage reference it agrees with.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from .llr import _pam_levels

_EPS = 1e-12


def mrc_llr(y, H, n0_total, Qm: int):
    """y, H: [..., A] complex; n0_total scalar or broadcastable to
    y.shape[:-1]. Returns [..., Qm] LLRs in ops/llr.demap_llr's order
    (bit 2*b + axis is bit b of the I (axis 0) or Q (axis 1) PAM level).

    y and h are pre-scaled by 1/sqrt(n0) per RE, which leaves the metric
    -(num - l*h2)^2/h2 equal to -(num0 - l*h20)^2/(h20*n0)."""
    levels, bit_of_level = _pam_levels(Qm)
    scale = jax.lax.rsqrt(jnp.asarray(n0_total, jnp.float32))[..., None]
    ys = y * scale
    hs = H * scale
    num_re = jnp.sum(ys.real * hs.real + ys.imag * hs.imag, axis=-1)
    num_im = jnp.sum(ys.imag * hs.real - ys.real * hs.imag, axis=-1)
    h2 = jnp.maximum(jnp.sum(hs.real ** 2 + hs.imag ** 2, axis=-1), _EPS)
    inv = 1.0 / h2
    # per-level metrics as separate arrays (no [..., L] tensor): the whole
    # chain is elementwise and max, which XLA fuses into one pass
    out = [None] * Qm
    for axis, v in ((0, num_re), (1, num_im)):
        metric = [-(v - float(lv) * h2) ** 2 * inv for lv in levels]
        for b in range(Qm // 2):
            m = [None, None]
            for li, bit in enumerate(bit_of_level[b].tolist()):
                m[bit] = metric[li] if m[bit] is None \
                    else jnp.maximum(m[bit], metric[li])
            out[2 * b + axis] = m[0] - m[1]
    return jnp.stack(out, axis=-1)
