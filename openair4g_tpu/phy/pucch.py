"""PUCCH formats 1/1a/1b (SR + HARQ ACK/NACK) and 2 (CQI), 36.211 §5.4.

Reference parity: openair1/PHY/LTE_TRANSPORT/pucch.c (generate_pucch :121 —
ZC base + per-symbol cyclic shift alpha from ncs_cell :67, W4/W3 orthogonal
covers :105-119, BPSK/QPSK payload d0 :303-318; rx_pucch :433) and 36.212
§5.2.3.3 (the (20, A) block code for format 2).

One PUCCH transmission is a tiny [n_sym, 12] tensor; everything
(covers, shifts, RS) is precomputed numpy, detection is batched conjugate
correlation. Format-2 ML decoding correlates LLRs against all 2^A codewords
with a single [B, 20] x [20, 2^A] matmul, replacing the reference's
per-codeword loop.
"""
from __future__ import annotations

import functools

import numpy as np
import jax.numpy as jnp

from ..ops.gold import gold_sequence
from .ulref import zc_base_sequence

# length-4 orthogonal covers for data symbols (36.211 Table 5.4.1-2)
_W4 = np.array([[1, 1, 1, 1],
                [1, -1, 1, -1],
                [1, -1, -1, 1]], np.float64)
# length-3 DFT covers for RS symbols (Table 5.5.2.2.1-2)
_W3 = np.exp(2j * np.pi / 3 * np.array([[0, 0, 0],
                                        [0, 1, 2],
                                        [0, 2, 1]], np.float64))

DATA_SYMS_F1 = (0, 1, 5, 6)    # within a slot, normal CP
RS_SYMS_F1 = (2, 3, 4)
DATA_SYMS_F2 = (0, 2, 3, 4, 6)
RS_SYMS_F2 = (1, 5)


@functools.lru_cache(maxsize=None)
def ncs_cell(nid_cell: int, normal_cp: bool = True) -> np.ndarray:
    """[20 slots, 7 syms] cell cyclic-shift hopping n_cs_cell(ns, l)
    (36.211 §5.4; reference init_ncs_cell pucch.c:67)."""
    nsym = 7 if normal_cp else 6
    c = gold_sequence(nid_cell, 8 * nsym * 20)
    out = np.zeros((20, nsym), np.int32)
    for ns in range(20):
        for l in range(nsym):
            v = 0
            for i in range(8):
                v += int(c[8 * nsym * ns + 8 * l + i]) << i
            out[ns, l] = v
    return out


def _alpha_seq(nid_cell: int, ns: int, l: int, n_cs1: int) -> np.ndarray:
    """Cyclically-shifted base sequence r_alpha(n) for slot ns, symbol l."""
    ncs = (int(ncs_cell(nid_cell)[ns, l]) + n_cs1) % 12
    alpha = 2.0 * np.pi * ncs / 12.0
    r = zc_base_sequence(0, 0, 12)
    return (np.exp(1j * alpha * np.arange(12)) * r).astype(np.complex64)


def pucch1_slot_symbols(nid_cell: int, ns: int, n_cs1: int, n_oc: int,
                        d: complex) -> tuple:
    """One slot of format 1/1a/1b.

    Returns (data [4, 12], rs [3, 12]) complex64. d = 1 (format 1 / SR),
    BPSK +-1 (1a), QPSK (1b).
    """
    data = np.stack([
        d * _W4[n_oc, i] * _alpha_seq(nid_cell, ns, l, n_cs1)
        for i, l in enumerate(DATA_SYMS_F1)])
    rs = np.stack([
        _W3[n_oc, i] * _alpha_seq(nid_cell, ns, l, n_cs1)
        for i, l in enumerate(RS_SYMS_F1)])
    return data.astype(np.complex64), rs.astype(np.complex64)


def pucch1_detect(rx_data, rx_rs, nid_cell: int, ns: int, n_cs1: int,
                  n_oc: int):
    """Coherent format-1 detection for one slot.

    rx_data [B, 4, 12], rx_rs [B, 3, 12] -> (z [B] complex decision variable,
    rs_energy [B]). d_hat = z; ACK/NACK = sign(Re z) (1a) or quadrant (1b);
    SR/DTX = |z|^2 against a threshold scaled by rs_energy.
    """
    data_ref, rs_ref = pucch1_slot_symbols(nid_cell, ns, n_cs1, n_oc, 1.0)
    h = jnp.sum(rx_rs * jnp.asarray(np.conj(rs_ref)), axis=(-1, -2))  # [B]
    z = jnp.sum(rx_data * jnp.asarray(np.conj(data_ref)), axis=(-1, -2))
    # normalize by the RS channel estimate (coherent demod)
    zc = z * jnp.conj(h)
    return zc, jnp.abs(h) ** 2


# ---------------------------------------------------------------------------
# Format 2: (20, A) block code, 36.212 Table 5.2.3.3-1
# ---------------------------------------------------------------------------

# basis sequences M_{i,n}, i = 0..19, n = 0..12 (spec constants)
RM20_BASIS = np.array([
    [1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 0],
    [1, 1, 1, 0, 0, 0, 0, 0, 0, 1, 1, 1, 0],
    [1, 0, 0, 1, 0, 0, 1, 0, 1, 1, 1, 1, 1],
    [1, 0, 1, 1, 0, 0, 0, 0, 1, 0, 1, 1, 1],
    [1, 1, 1, 1, 0, 0, 0, 1, 0, 0, 1, 1, 1],
    [1, 1, 0, 0, 1, 0, 1, 1, 1, 0, 1, 1, 1],
    [1, 0, 1, 0, 1, 0, 1, 0, 1, 1, 1, 1, 1],
    [1, 0, 0, 1, 1, 0, 0, 1, 1, 0, 1, 1, 1],
    [1, 1, 0, 1, 1, 0, 0, 1, 0, 1, 1, 1, 1],
    [1, 0, 1, 1, 1, 0, 1, 0, 0, 1, 1, 1, 1],
    [1, 0, 1, 0, 0, 1, 1, 1, 0, 1, 1, 1, 1],
    [1, 1, 1, 0, 0, 1, 1, 0, 1, 0, 1, 1, 1],
    [1, 0, 0, 1, 0, 1, 0, 1, 1, 1, 1, 1, 1],
    [1, 1, 0, 1, 0, 1, 0, 1, 0, 1, 1, 1, 1],
    [1, 0, 0, 0, 1, 1, 0, 1, 0, 0, 1, 0, 1],
    [1, 1, 0, 0, 1, 1, 1, 1, 0, 1, 1, 0, 1],
    [1, 1, 1, 0, 1, 1, 1, 0, 0, 1, 0, 1, 1],
    [1, 0, 0, 1, 1, 1, 0, 0, 1, 0, 0, 1, 1],
    [1, 1, 0, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0],
    [1, 0, 0, 0, 0, 1, 1, 0, 0, 0, 0, 0, 0]], np.int8)


def rm20_encode(a_bits: np.ndarray) -> np.ndarray:
    """a [A<=13] -> 20 coded bits."""
    A = len(a_bits)
    return (RM20_BASIS[:, :A] @ np.asarray(a_bits, np.int64)) % 2


@functools.lru_cache(maxsize=None)
def _rm20_codebook(A: int) -> np.ndarray:
    """[2^A, 20] all codewords (for ML decoding)."""
    msgs = ((np.arange(1 << A)[:, None] >> np.arange(A)) & 1).astype(np.int64)
    return (msgs @ RM20_BASIS[:, :A].T.astype(np.int64)) % 2


def rm20_decode(llr20, A: int):
    """ML decode. llr20 [B, 20] (positive <=> bit 0) -> bits [B, A]."""
    cb = _rm20_codebook(A)                                  # [2^A, 20]
    sgn = jnp.asarray((1.0 - 2.0 * cb).astype(np.float32))
    scores = llr20 @ sgn.T                                  # [B, 2^A]
    best = jnp.argmax(scores, axis=-1)
    bits = (best[:, None] >> jnp.arange(A)) & 1
    return bits


def pucch2_slot_symbols(nid_cell: int, ns: int, n_cs1: int,
                        d5: np.ndarray) -> tuple:
    """One slot of format 2: 5 QPSK payload symbols d5 [5] spread over the
    shifted base sequence; RS on symbols 1 and 5."""
    data = np.stack([
        d5[i] * _alpha_seq(nid_cell, ns, l, n_cs1)
        for i, l in enumerate(DATA_SYMS_F2)])
    rs = np.stack([
        _alpha_seq(nid_cell, ns, l, n_cs1)
        for l in RS_SYMS_F2])
    return data.astype(np.complex64), rs.astype(np.complex64)


def pucch2_equalize(rx_data, rx_rs, nid_cell: int, ns: int, n_cs1: int):
    """rx_data [B, 5, 12], rx_rs [B, 2, 12] -> d_hat [B, 5] (coherent)."""
    _, rs_ref = pucch2_slot_symbols(nid_cell, ns, n_cs1, np.ones(5))
    seqs = np.stack([_alpha_seq(nid_cell, ns, l, n_cs1)
                     for l in DATA_SYMS_F2])
    h = jnp.sum(rx_rs * jnp.asarray(np.conj(rs_ref)), axis=(-1, -2))  # [B]
    z = jnp.sum(rx_data * jnp.asarray(np.conj(seqs)), axis=-1)        # [B, 5]
    return z * jnp.conj(h)[:, None], jnp.abs(h) ** 2


# ----------------------------------------------------------- formats 2a/2b
# Mixed CQI + ACK (36.211 §5.4.2 Table 5.4.2-1): the 1-2 HARQ-ACK bits
# modulate the SECOND RS symbol of each slot (normal CP: symbol 5) as
# BPSK (2a) / QPSK (2b) while the 20 CQI bits ride the 5 data symbols
# exactly as format 2. The reference stubs these out ("not implemented",
# pucch.c:330-334); this is the full TX+RX per spec — capability beyond
# the reference, same API family as pucch2_*.

def pucch2x_ack_symbol(ack_bits) -> complex:
    """36.211 Table 5.4.2-1: 1 bit -> BPSK {0:+1, 1:-1};
    2 bits -> QPSK {00:+1, 01:-j, 10:+j, 11:-1}."""
    b = tuple(int(x) for x in np.atleast_1d(ack_bits))
    if len(b) == 1:
        return 1.0 + 0j if b[0] == 0 else -1.0 + 0j
    return {(0, 0): 1 + 0j, (0, 1): -1j, (1, 0): 1j, (1, 1): -1 + 0j}[b]


def pucch2x_slot_symbols(nid_cell: int, ns: int, n_cs1: int,
                         d5: np.ndarray, d_ack: complex) -> tuple:
    """Format 2a/2b slot: like format 2 but the second RS symbol carries
    d_ack. Returns (data [5,12], rs [2,12])."""
    data, rs = pucch2_slot_symbols(nid_cell, ns, n_cs1, d5)
    rs = rs.copy()
    rs[1] = rs[1] * np.complex64(d_ack)
    return data, rs


def pucch2x_detect(rx_data, rx_rs, nid_cell: int, ns: int, n_cs1: int,
                   n_ack: int):
    """Joint CQI + ACK RX for one slot.

    rx_data [B, 5, 12], rx_rs [B, 2, 12]. Channel is estimated from the
    FIRST RS symbol (ACK-free); the ACK symbol is detected coherently
    against it; the CQI symbols are equalized with both RS symbols after
    wiping the detected ACK modulation (max-ratio, matching rx_pucch's
    coherent structure). Returns (z5 [B,5] equalized CQI symbols,
    h2 [B] channel power, ack_bits [B, n_ack])."""
    _, rs_ref = pucch2_slot_symbols(nid_cell, ns, n_cs1, np.ones(5))
    seqs = np.stack([_alpha_seq(nid_cell, ns, l, n_cs1)
                     for l in DATA_SYMS_F2])
    h1 = jnp.sum(rx_rs[:, 0] * jnp.asarray(np.conj(rs_ref[0])), axis=-1)
    z_ack = jnp.sum(rx_rs[:, 1] * jnp.asarray(np.conj(rs_ref[1])), axis=-1)
    rho = z_ack * jnp.conj(h1)                       # ~ |h|^2 * d_ack
    if n_ack == 1:
        ack = (rho.real < 0).astype(jnp.int32)[:, None]
        d_hat = 1.0 - 2.0 * ack[:, 0]
    else:
        # ML slicing on {1, -j, +j, -1}: the nearest constellation point is
        # decided by which of |Re|,|Im| dominates and its sign
        ack0 = ((rho.imag > 0) & (jnp.abs(rho.imag) > jnp.abs(rho.real))) | \
               ((rho.real < 0) & (jnp.abs(rho.real) > jnp.abs(rho.imag)))
        ack1 = ((rho.imag < 0) & (jnp.abs(rho.imag) > jnp.abs(rho.real))) | \
               ((rho.real < 0) & (jnp.abs(rho.real) > jnp.abs(rho.imag)))
        ack = jnp.stack([ack0, ack1], axis=-1).astype(jnp.int32)
        pts = jnp.asarray([1 + 0j, -1j, 1j, -1 + 0j], jnp.complex64)
        d_hat = pts[ack[:, 0] * 2 + ack[:, 1]]
    # wipe ACK modulation off the second RS and MRC both RS symbols
    h2s = z_ack * jnp.conj(d_hat)
    h = 0.5 * (h1 + h2s)
    z = jnp.sum(rx_data * jnp.asarray(np.conj(seqs)), axis=-1)  # [B,5]
    return z * jnp.conj(h)[:, None], jnp.abs(h) ** 2, ack
