"""QAM mapping and max-log LLR demapping, 3GPP TS 36.211 §7.1.

Reference parity: openair1/PHY/LTE_TRANSPORT/dlsch_modulation.c (mapping)
and dlsch_llr_computation.c:636/688/810 (QPSK/16QAM/64QAM max-log LLRs).

The reference computes LLRs with Q15 folding tricks (|y|-mag cascades); here
the exact max-log LLR is computed from per-axis distances to the Gray-coded
PAM levels — a handful of elementwise ops per RE, batched over everything, and correct
for any noise variance (the N0 scaling matters once 16/64QAM rings are mixed).

Convention: LLR = log P(bit=0)/P(bit=1) (positive <=> bit 0), bits MSB-first
per symbol (b0 = I sign, b1 = Q sign, ...).
"""
from __future__ import annotations

import functools

import numpy as np
import jax.numpy as jnp

from ..tables.modulation import mod_table


def map_symbols(bits, Qm: int):
    """bits [B, E] {0,1} int -> complex symbols [B, E/Qm].

    Closed-form Gray/PAM arithmetic instead of a constellation-table
    gather (36.211 Table 7.1.x separable mapping: per axis,
    QPSK 1; 16QAM 2-(1-2b); 64QAM 4-(1-2b)(2-(1-2b')); all times the
    sign bit) — a few elementwise ops that fuse into the surrounding
    program, where a [B, E] table gather would be a separate pass. Bit-exact vs tables.modulation
    (tests/test_chain).
    """
    B, E = bits.shape
    assert E % Qm == 0
    b = bits.reshape(B, E // Qm, Qm).astype(jnp.float32)
    s = 1.0 - 2.0 * b                       # (1-2b) per position
    if Qm == 2:
        amp_i = amp_q = 1.0
        norm = np.sqrt(2.0)
    elif Qm == 4:
        amp_i = 2.0 - s[..., 2]
        amp_q = 2.0 - s[..., 3]
        norm = np.sqrt(10.0)
    elif Qm == 6:
        amp_i = 4.0 - s[..., 2] * (2.0 - s[..., 4])
        amp_q = 4.0 - s[..., 3] * (2.0 - s[..., 5])
        norm = np.sqrt(42.0)
    else:
        raise ValueError(f"Qm={Qm}")
    re = s[..., 0] * amp_i / norm
    im = s[..., 1] * amp_q / norm
    return (re + 1j * im).astype(jnp.complex64)


@functools.lru_cache(maxsize=None)
def _pam_levels(Qm: int):
    """Per-axis PAM levels and, per bit-of-axis, the level subsets.

    Returns (levels [L], bit_of_level [n_axis_bits, L] in {0,1}) where
    n_axis_bits = Qm//2. Axis bit 0 is the sign bit, the rest are ring bits.
    """
    table = mod_table(Qm)
    nb = Qm // 2
    # Real parts of symbols whose Q-axis bits are all zero give the I levels.
    levels = []
    bit_patterns = []
    for idx in range(1 << Qm):
        bits = [(idx >> (Qm - 1 - k)) & 1 for k in range(Qm)]
        # I axis bits: b0, b2, b4 (even positions)
        if all(bits[k] == 0 for k in range(1, Qm, 2)):
            levels.append(table[idx].real)
            bit_patterns.append([bits[k] for k in range(0, Qm, 2)])
    levels = np.asarray(levels, np.float32)              # [2^nb]
    bits_arr = np.asarray(bit_patterns, np.int8).T        # [nb, 2^nb]
    return levels, bits_arr


def demap_llr(y, N0, Qm: int):
    """Exact max-log LLRs. y [...] complex equalized symbols (unit-energy
    constellation), N0 scalar/broadcastable complex-noise variance.
    Returns [..., Qm] LLRs, bit order b0..b{Qm-1}.
    """
    levels, bit_of_level = _pam_levels(Qm)   # [L], [nb, L]
    lv = jnp.asarray(levels)
    nb = Qm // 2
    N0b = jnp.asarray(N0)
    inv_n0 = 1.0 / (N0b[..., None] if N0b.ndim else N0b)
    out = []
    for axis_val in (y.real, y.imag):
        d2 = (axis_val[..., None] - lv) ** 2            # [..., L]
        metric = -d2 * inv_n0
        axis_llrs = []
        for b in range(nb):
            mask0 = jnp.asarray(bit_of_level[b] == 0)
            m0 = jnp.max(jnp.where(mask0, metric, -jnp.inf), axis=-1)
            m1 = jnp.max(jnp.where(~mask0, metric, -jnp.inf), axis=-1)
            axis_llrs.append(m0 - m1)
        out.append(axis_llrs)
    # interleave: b0 (I), b1 (Q), b2 (I ring), b3 (Q ring), ...
    ordered = []
    for b in range(nb):
        ordered.append(out[0][b])
        ordered.append(out[1][b])
    return jnp.stack(ordered, axis=-1)
