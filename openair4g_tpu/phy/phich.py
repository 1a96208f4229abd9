"""PHICH: HARQ ACK/NACK indicator channel, 36.211 §6.9.

Reference parity: openair1/PHY/LTE_TRANSPORT/phich.c (generate_phich /
rx_phich — BPSK HI repeated 3x, spread by length-4 orthogonal sequences
(8 sequences: 4 Walsh x {1,j}), groups of 8 UEs share 3 REGs; REG positions
from the PHICH resource allocation in frame parms).

A PHICH group is a [3, 4] complex tensor (3 REGs x 4 REs);
TX/RX of all 8 sequences in a group is one small einsum, batched over
groups and trials.
"""
from __future__ import annotations

import functools

import numpy as np
import jax.numpy as jnp

from ..config import FrameParms
from ..ops.gold import gold_sequence

N_SF = 4  # spreading factor, normal CP

# 36.211 Table 6.9.1-2: orthogonal sequences w (normal CP), index 0..7
_W = np.array([
    [1, 1, 1, 1],
    [1, -1, 1, -1],
    [1, 1, -1, -1],
    [1, -1, -1, 1],
    [1j, 1j, 1j, 1j],
    [1j, -1j, 1j, -1j],
    [1j, 1j, -1j, -1j],
    [1j, -1j, -1j, 1j]], np.complex64)


def phich_scramble(nid_cell: int, ns: int) -> np.ndarray:
    """[12] scrambling chips c(i) for one group (c_init 36.211 §6.9.1)."""
    cinit = ((ns // 2 + 1) * (2 * nid_cell + 1) << 9) + nid_cell
    return (1.0 - 2.0 * gold_sequence(cinit, 12).astype(np.float64))


def phich_group_tx(acks: np.ndarray, nid_cell: int, ns: int) -> np.ndarray:
    """One PHICH group: acks [8] in {0 (NACK), 1 (ACK), -1 (off)} ->
    [12] complex REs (3 REGs x 4, before RE mapping).

    HI bits b(i): ACK -> 1,1,1 (BPSK +), NACK -> 0,0,0. z(i) = w(i mod 4) *
    (1 - 2*b(i/4))... following the spec: d(i) = w(i mod N_SF) * (1-2b) *
    c(i) over 12 chips.
    """
    c = phich_scramble(nid_cell, ns)
    out = np.zeros(12, np.complex128)
    for seq in range(8):
        a = acks[seq]
        if a < 0:
            continue
        s = 1.0 if a else -1.0      # BPSK: ACK=+1, NACK=-1
        w = _W[seq]
        d = s * np.tile(w, 3) * c   # [12]
        out += d
    return (out / np.sqrt(2)).astype(np.complex64)


def phich_group_rx(rx12, nid_cell: int, ns: int):
    """rx12 [B, 12] -> decision variables z [B, 8] (one per sequence).

    The decision statistic is Re(z): > 0 => ACK, < 0 => NACK,
    |Re(z)| small => DTX/off. (The {1,j}-rotated sequence pairs are
    orthogonal in the *real* part only — cross-talk lands on the imaginary
    axis, exactly like the reference's I/Q-split despreading.) Channel
    assumed pre-equalized by the caller.
    """
    c = phich_scramble(nid_cell, ns)
    ref = np.tile(_W, (1, 3)) * c[None, :]          # [8, 12]
    return rx12 @ jnp.asarray(np.conj(ref).T / 12.0)


@functools.lru_cache(maxsize=None)
def phich_reg_positions(n_rb: int, nid_cell: int, n_group: int = 1):
    """Symbol-0 REG subcarrier quadruplets for n_group PHICH groups
    (36.211 §6.9.3 mapping, simplified to the non-colliding REGs after
    PCFICH, spread maximally across the band like the spec's
    n_bar_i = (Nid + i*floor(n_reg/3)) pattern). Shares the REG choice
    with control_region.make_control_region_map(n_phich_groups=...) so the
    PDCCH never collides with the PHICH."""
    from .control_region import _regs_in_symbol, phich_reg_indices
    fp = FrameParms(n_rb=n_rb, n_id_cell=nid_cell)
    regs = _regs_in_symbol(fp, 0)
    out = [np.concatenate([regs[i] for i in idx])
           for idx in phich_reg_indices(fp, n_group)]
    return np.stack(out)     # [n_group, 12] subcarrier indices in symbol 0
