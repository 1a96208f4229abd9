"""PMCH / MBSFN: multicast channel over extended-CP subframes,
36.211 §6.5/§6.10.2.

Reference parity: openair1/PHY/LTE_TRANSPORT/pmch.c (mch_modulation,
MBSFN RE allocation skipping the dense MBSFN RS), LTE_REFSIG/lte_gold_mbsfn.c
and lte_dl_mbsfn.c (MBSFN reference signals on antenna port 4),
MODULATION/slot_fep_mbsfn.c (extended-CP front end).

The MBSFN subframe is one static grid map like the PDSCH maps;
the denser RS comb (spacing 2) makes channel estimation a plain per-RE LS +
delay-domain smoothing matmul — the long MBSFN composite channel (multiple
cells transmitting the same waveform at different delays) stays within the
extended CP by construction.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import jax.numpy as jnp

from ..config import FrameParms
from ..ops.gold import gold_sequence

# MBSFN region: extended-CP symbol indices carrying the port-4 RS and
# their frequency offsets (36.211 Table 6.10.2.2-1, Delta_f = 15 kHz):
# l = 2 of slot 0, l = 0 and l = 4 of slot 1; comb spacing 2.
MBSFN_RS_SYMS = (2, 6, 10)
MBSFN_RS_OFFS = (0, 1, 0)
MBSFN_REGION_START = 2           # symbols 0..1 = (unused here) control


def mbsfn_rs_values(n_id_mbsfn: int, subframe: int, sym: int,
                    n_rb: int) -> np.ndarray:
    """QPSK MBSFN RS r(m) (36.211 §6.10.2.1: c_init = 2^9 * (7(ns+1)+l+1) *
    (2*Nid+1) + Nid, ns = slot, l = symbol in slot, ECP)."""
    ns = 2 * subframe + (1 if sym >= 6 else 0)
    l = sym % 6
    cinit = ((1 << 9) * (7 * (ns + 1) + l + 1) * (2 * n_id_mbsfn + 1)
             + n_id_mbsfn)
    n_rb_max = 110
    c = gold_sequence(cinit, 12 * n_rb_max).astype(np.float64)
    m = np.arange(6 * n_rb) + 3 * (n_rb_max - n_rb)
    re = (1 - 2 * c[2 * m]) / np.sqrt(2)
    im = (1 - 2 * c[2 * m + 1]) / np.sqrt(2)
    return (re + 1j * im).astype(np.complex64)


@dataclass(frozen=True)
class MbsfnMap:
    fp: FrameParms
    n_data_re: int
    data_sym: np.ndarray
    data_sc: np.ndarray
    data_bin: np.ndarray
    rs_sym: np.ndarray
    rs_sc: np.ndarray
    rs_bin: np.ndarray
    rs_val: np.ndarray


@functools.lru_cache(maxsize=None)
def make_mbsfn_map(n_rb: int, n_id_mbsfn: int = 0,
                   subframe: int = 1) -> MbsfnMap:
    """Static RE map of one MBSFN subframe (extended CP, 12 symbols):
    PMCH data on symbols 2..11 minus the port-4 RS comb."""
    fp = FrameParms(n_rb=n_rb, normal_cp=False, n_id_cell=n_id_mbsfn)
    rs_sym, rs_sc, rs_val = [], [], []
    rs_at = {}
    for sym, off in zip(MBSFN_RS_SYMS, MBSFN_RS_OFFS):
        scs = np.arange(off, fp.n_sc, 2, dtype=np.int32)
        rs_at[sym] = set(scs.tolist())
        rs_sym.append(np.full(len(scs), sym, np.int32))
        rs_sc.append(scs)
        rs_val.append(mbsfn_rs_values(n_id_mbsfn, subframe, sym, n_rb))
    rs_sym = np.concatenate(rs_sym)
    rs_sc = np.concatenate(rs_sc)
    rs_val = np.concatenate(rs_val)

    data_sym, data_sc = [], []
    for sym in range(MBSFN_REGION_START, fp.symbols_per_subframe):
        skip = rs_at.get(sym, set())
        for k in range(fp.n_sc):
            if k not in skip:
                data_sym.append(sym)
                data_sc.append(k)
    data_sym = np.asarray(data_sym, np.int32)
    data_sc = np.asarray(data_sc, np.int32)
    return MbsfnMap(fp=fp, n_data_re=len(data_sym), data_sym=data_sym,
                    data_sc=data_sc, data_bin=fp.sc_to_bin(data_sc),
                    rs_sym=rs_sym, rs_sc=rs_sc, rs_bin=fp.sc_to_bin(rs_sc),
                    rs_val=rs_val)


def pmch_cinit(n_id_mbsfn: int, subframe: int) -> int:
    """PMCH scrambling c_init (36.211 §6.3.1, PMCH case):
    c_init = (ns/2)*2^9 + N_ID^MBSFN."""
    return (subframe << 9) + n_id_mbsfn


def mbsfn_fill_grid(symbols, mm: MbsfnMap):
    """symbols [B, n_data_re] -> grid [B, 12, n_fft] with MBSFN RS."""
    B = symbols.shape[0]
    fp = mm.fp
    grid = jnp.zeros((B, fp.symbols_per_subframe, fp.n_fft), jnp.complex64)
    grid = grid.at[:, jnp.asarray(mm.data_sym),
                   jnp.asarray(mm.data_bin)].set(symbols)
    grid = grid.at[:, jnp.asarray(mm.rs_sym), jnp.asarray(mm.rs_bin)].set(
        jnp.asarray(mm.rs_val))
    return grid


@functools.lru_cache(maxsize=None)
def _mbsfn_wiener(n_rb: int, n0: float) -> np.ndarray:
    """Delay-domain LMMSE smoother for the spacing-2 RS comb: prior uniform
    over the *extended* CP (the MBSFN composite channel is that long)."""
    fp = FrameParms(n_rb=n_rb, normal_cp=False)
    m = 6 * n_rb
    f_idx = 2 * np.arange(m) - 6 * n_rb      # comb at spacing 2
    L = fp.cp
    taps = np.arange(L)
    F = np.exp(-2j * np.pi * f_idx[:, None] * taps[None, :] / fp.n_fft)
    P = 1.0 / L
    A = (F * P) @ F.conj().T + n0 * np.eye(m)
    W = (F * P) @ F.conj().T @ np.linalg.inv(A)
    return W.T.astype(np.complex64)


def mbsfn_estimate_channel(rgrid, mm: MbsfnMap, n0: float):
    """LS at the RS comb -> smooth -> interpolate to all data REs.

    rgrid [B, 12, n_fft] -> H_hat [B, n_data_re]. Time interpolation is a
    per-symbol linear blend between the nearest RS symbols (2/6/10)."""
    B = rgrid.shape[0]
    fp = mm.fp
    n_per = 6 * fp.n_rb
    W = jnp.asarray(_mbsfn_wiener(fp.n_rb, float(n0)))
    hs = []
    for i, sym in enumerate(MBSFN_RS_SYMS):
        sl = slice(i * n_per, (i + 1) * n_per)
        ls = rgrid[:, sym, jnp.asarray(mm.rs_bin[sl])] * \
            jnp.conj(jnp.asarray(mm.rs_val[sl]))
        hs.append(jnp.matmul(ls, W, preferred_element_type=jnp.complex64))
    h_rs = jnp.stack(hs, axis=1)     # [B, 3, n_per] on the comb

    # frequency: nearest-comb sample for every subcarrier (spacing 2 -> the
    # smoothing already reconstructs the full band to CP resolution)
    # time: linear interpolation between RS symbols per data symbol
    sym_f = np.asarray(MBSFN_RS_SYMS, np.float64)
    out = []
    k_all = np.arange(fp.n_sc)
    idx = jnp.asarray(np.clip(k_all // 2, 0, n_per - 1))
    for sym in range(MBSFN_REGION_START, fp.symbols_per_subframe):
        seg = int(np.clip(np.searchsorted(sym_f, sym) - 1, 0, 1))
        t01 = float(np.clip((sym - sym_f[seg])
                            / (sym_f[seg + 1] - sym_f[seg]), 0.0, 1.0))
        h_sym = (1 - t01) * h_rs[:, seg] + t01 * h_rs[:, seg + 1]
        out.append(h_sym[:, idx])
    H = jnp.stack(out, axis=1)       # [B, 10, n_sc]
    sym_rel = mm.data_sym - MBSFN_REGION_START
    return H[:, jnp.asarray(sym_rel), jnp.asarray(mm.data_sc)]
