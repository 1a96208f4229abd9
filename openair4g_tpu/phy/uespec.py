"""UE-specific reference signals (antenna port 5) and TM7 beamforming,
36.211 §6.10.3.

Reference parity: openair1/PHY/LTE_REFSIG/lte_dl_uespec.c (lte_gold_ue_spec
— per-RNTI Gold sequence, c_init = (ns/2+1)(2Nid+1)2^16 + rnti) and the
TM7 path of dlsch_modulation.c (data and DMRS transmitted through the same
arbitrary beamforming vector, so the UE estimates the *effective* beamformed
channel directly from port 5 — no codebook).

The RS lattice is one static map per allocation; beamforming is
an outer product with the beam vector; channel estimation is LS at the RS
comb + the same delay-domain LMMSE smoother as the cell-specific path.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import jax.numpy as jnp

from ..config import FrameParms
from ..ops.gold import gold_sequence

# port-5 RS symbols within a subframe (normal CP) and per-symbol comb
# offsets: density 12 RE/PRB/subframe on a spacing-4 comb (36.211 Fig.
# 6.10.3.2-1)
UE_RS_SYMS = (3, 6, 9, 12)
UE_RS_OFFS = (0, 2, 0, 2)


def ue_rs_values(rnti: int, nid_cell: int, subframe: int, sym: int,
                 n_prb: int) -> np.ndarray:
    """QPSK r(m) for one RS symbol over n_prb PRBs (3 REs/PRB).

    c_init = ((ns/2)+1) * (2*Nid+1) * 2^16 + rnti (36.211 §6.10.3.1)."""
    ns = 2 * subframe + (1 if sym >= 7 else 0)
    cinit = (((ns // 2) + 1) * (2 * nid_cell + 1) << 16) + rnti
    c = gold_sequence(cinit, 6 * n_prb).astype(np.float64)
    m = np.arange(3 * n_prb)
    re = (1 - 2 * c[2 * m]) / np.sqrt(2)
    im = (1 - 2 * c[2 * m + 1]) / np.sqrt(2)
    return (re + 1j * im).astype(np.complex64)


@dataclass(frozen=True)
class UeSpecMap:
    """RE map of one TM7 allocation: beamformed data + port-5 RS."""
    fp: FrameParms
    rb_start: int
    n_prb: int
    n_data_re: int
    data_sym: np.ndarray
    data_sc: np.ndarray
    data_bin: np.ndarray
    rs_sym: np.ndarray
    rs_sc: np.ndarray
    rs_bin: np.ndarray
    rs_val: np.ndarray


@functools.lru_cache(maxsize=None)
def make_uespec_map(n_rb: int, rb_start: int, n_prb: int, rnti: int,
                    nid_cell: int = 0, subframe: int = 7,
                    n_pdcch: int = 1) -> UeSpecMap:
    """Data REs = allocation minus cell RS (port 0) minus port-5 RS."""
    from .resource_grid import pilot_symbol_indices, pilot_sc_positions
    fp = FrameParms(n_rb=n_rb, n_id_cell=nid_cell)
    crs_syms = set(pilot_symbol_indices(fp))
    rs_sym, rs_sc, rs_val = [], [], []
    rs_at = {}
    for sym, off in zip(UE_RS_SYMS, UE_RS_OFFS):
        k = 12 * rb_start + np.arange(off, 12 * n_prb, 4, dtype=np.int32)
        rs_at[sym] = set(k.tolist())
        rs_sym.append(np.full(len(k), sym, np.int32))
        rs_sc.append(k)
        rs_val.append(ue_rs_values(rnti, nid_cell, subframe, sym, n_prb))
    rs_sym = np.concatenate(rs_sym)
    rs_sc = np.concatenate(rs_sc)
    rs_val = np.concatenate(rs_val)

    data_sym, data_sc = [], []
    for sym in range(n_pdcch, fp.symbols_per_subframe):
        skip = set(rs_at.get(sym, set()))
        if sym in crs_syms:
            skip |= set(pilot_sc_positions(fp, sym, 0).tolist())
        for k in range(12 * rb_start, 12 * (rb_start + n_prb)):
            if k not in skip:
                data_sym.append(sym)
                data_sc.append(k)
    data_sym = np.asarray(data_sym, np.int32)
    data_sc = np.asarray(data_sc, np.int32)
    return UeSpecMap(fp=fp, rb_start=rb_start, n_prb=n_prb,
                     n_data_re=len(data_sym), data_sym=data_sym,
                     data_sc=data_sc, data_bin=fp.sc_to_bin(data_sc),
                     rs_sym=rs_sym, rs_sc=rs_sc,
                     rs_bin=fp.sc_to_bin(rs_sc), rs_val=rs_val)


def tm7_fill_ports(symbols, um: UeSpecMap, beam):
    """symbols [B, n_data_re], beam [B, P] -> per-port grids [B, P, 14, F].

    Data AND port-5 RS go through the same beam (the whole point of TM7:
    the UE sees one effective channel h_eff = H @ w)."""
    B = symbols.shape[0]
    fp = um.fp
    P = beam.shape[1]
    grid = jnp.zeros((B, fp.symbols_per_subframe, fp.n_fft), jnp.complex64)
    grid = grid.at[:, jnp.asarray(um.data_sym),
                   jnp.asarray(um.data_bin)].set(symbols)
    grid = grid.at[:, jnp.asarray(um.rs_sym), jnp.asarray(um.rs_bin)].set(
        jnp.asarray(um.rs_val))
    return grid[:, None] * beam[:, :, None, None]


def tm7_estimate(rgrid, um: UeSpecMap, n0: float):
    """LS at the port-5 comb -> delay-domain LMMSE smooth -> per-symbol
    linear time interpolation. rgrid [B, 14, F] -> h_eff [B, n_data_re]."""
    fp = um.fp
    n_per = 3 * um.n_prb
    hs = []
    for i, sym in enumerate(UE_RS_SYMS):
        W = _uespec_wiener(fp.n_rb, um.n_prb, float(n0), UE_RS_OFFS[i])
        sl = slice(i * n_per, (i + 1) * n_per)
        ls = rgrid[:, sym, jnp.asarray(um.rs_bin[sl])] * \
            jnp.conj(jnp.asarray(um.rs_val[sl]))
        hs.append(jnp.matmul(ls, jnp.asarray(W),
                             preferred_element_type=jnp.complex64))
    h_rs = jnp.stack(hs, axis=1)       # [B, 4, n_sc_alloc]
    # quasi-static assumption (beamformed PDSCH): average over RS symbols
    h_bar = jnp.mean(h_rs, axis=1)     # [B, 12*n_prb]
    rel = um.data_sc - 12 * um.rb_start
    return h_bar[:, jnp.asarray(rel)]


@functools.lru_cache(maxsize=None)
def _comb_wiener(n_rb: int, n_prb: int, n0: float,
                 k_rs: tuple) -> np.ndarray:
    """[len(k_rs), 12*n_prb] LMMSE interpolator from an arbitrary RS comb
    (allocation-relative subcarriers `k_rs`) to every subcarrier of the
    allocation (delay prior uniform over the CP)."""
    fp = FrameParms(n_rb=n_rb)
    k_rs = np.asarray(k_rs)
    k_all = np.arange(12 * n_prb)
    L = fp.cp
    taps = np.arange(L)
    F_rs = np.exp(-2j * np.pi * k_rs[:, None] * taps[None, :] / fp.n_fft)
    F_all = np.exp(-2j * np.pi * k_all[:, None] * taps[None, :] / fp.n_fft)
    P = 1.0 / L
    A = (F_rs * P) @ F_rs.conj().T + n0 * np.eye(len(k_rs))
    W = (F_all * P) @ F_rs.conj().T @ np.linalg.inv(A)   # [12n, |rs|]
    return W.T.astype(np.complex64)                       # ls @ W


def _uespec_wiener(n_rb: int, n_prb: int, n0: float,
                   off: int = 0) -> np.ndarray:
    """Port-5 spacing-4 comb specialization of `_comb_wiener`."""
    return _comb_wiener(n_rb, n_prb, n0,
                        tuple(range(off, 12 * n_prb, 4)))


# ---------------------------------------------------------------- TM8 ----
# Dual-layer beamforming on antenna ports 7/8 (36.211 Rel-9 §6.10.3):
# DM-RS pairs on symbols (5,6) and (12,13), subcarrier offsets {1,6,11}
# per PRB (12 RE/PRB/subframe shared by both ports), ports separated by a
# length-2 orthogonal cover code over each time pair: w_7=(+1,+1),
# w_8=(+1,-1).  c_init = ((ns/2)+1)(2Nid+1)2^16 + n_SCID (per-slot seq).
#
# Reference parity: the reference tree is Rel-8/early-Rel-10 — TM8 ports
# 7/8 are declared in its DCI/RRC tables (openair1/PHY/impl_defs_lte.h
# transmission-mode enums) but the modulation path stops at TM7 (port 5,
# dlsch_modulation.c:1181). This module completes the capability the
# reference names, built like the TM7 path above.

TM8_RS_SYMS = (5, 6, 12, 13)
TM8_SC_OFFS = (1, 6, 11)            # per-PRB DM-RS subcarrier offsets
TM8_OCC = np.array([[1.0, 1.0], [1.0, -1.0]], np.float32)  # [port, l']


def tm8_rs_values(nid_cell: int, subframe: int, slot_in_sf: int,
                  n_prb: int, n_scid: int = 0) -> np.ndarray:
    """Per-slot DM-RS base sequence r(m) over the allocation (3 REs/PRB)."""
    ns = 2 * subframe + slot_in_sf
    cinit = (((ns // 2) + 1) * (2 * nid_cell + 1) << 16) + n_scid
    c = gold_sequence(cinit, 6 * n_prb).astype(np.float64)
    m = np.arange(3 * n_prb)
    re = (1 - 2 * c[2 * m]) / np.sqrt(2)
    im = (1 - 2 * c[2 * m + 1]) / np.sqrt(2)
    return (re + 1j * im).astype(np.complex64)


@dataclass(frozen=True)
class Tm8Map:
    """RE map of one TM8 dual-layer allocation (ports 7/8)."""
    fp: FrameParms
    rb_start: int
    n_prb: int
    n_data_re: int
    data_sym: np.ndarray
    data_sc: np.ndarray
    data_bin: np.ndarray
    rs_sym: np.ndarray      # [4, n_rs] (per DM-RS symbol)
    rs_bin: np.ndarray      # [n_rs] (same comb every symbol)
    rs_sc_rel: np.ndarray   # allocation-relative comb subcarriers
    rs_val: np.ndarray      # [2 slots, n_rs] base sequence r(m)


@functools.lru_cache(maxsize=None)
def make_tm8_map(n_rb: int, rb_start: int, n_prb: int, nid_cell: int = 0,
                 subframe: int = 7, n_pdcch: int = 1,
                 n_scid: int = 0) -> Tm8Map:
    from .resource_grid import pilot_symbol_indices, pilot_sc_positions
    fp = FrameParms(n_rb=n_rb, n_id_cell=nid_cell)
    crs_syms = set(pilot_symbol_indices(fp))
    rel = np.concatenate([12 * p + np.asarray(TM8_SC_OFFS, np.int32)
                          for p in range(n_prb)])
    rs_sc = 12 * rb_start + rel
    rs_set = set(rs_sc.tolist())
    rs_val = np.stack([tm8_rs_values(nid_cell, subframe, s, n_prb, n_scid)
                       for s in (0, 1)])

    data_sym, data_sc = [], []
    for sym in range(n_pdcch, fp.symbols_per_subframe):
        skip = rs_set if sym in TM8_RS_SYMS else set()
        if sym in crs_syms:
            skip = skip | set(pilot_sc_positions(fp, sym, 0).tolist())
        for k in range(12 * rb_start, 12 * (rb_start + n_prb)):
            if k not in skip:
                data_sym.append(sym)
                data_sc.append(k)
    data_sym = np.asarray(data_sym, np.int32)
    data_sc = np.asarray(data_sc, np.int32)
    rs_sym = np.asarray(TM8_RS_SYMS, np.int32)
    return Tm8Map(fp=fp, rb_start=rb_start, n_prb=n_prb,
                  n_data_re=len(data_sym), data_sym=data_sym,
                  data_sc=data_sc, data_bin=fp.sc_to_bin(data_sc),
                  rs_sym=rs_sym, rs_bin=fp.sc_to_bin(rs_sc),
                  rs_sc_rel=rel, rs_val=rs_val)


def tm8_fill_ports(layers, tm: Tm8Map, beams):
    """layers [B, 2, n_data_re], beams [B, P, 2] -> grids [B, P, 14, F].

    Each layer rides its own beam; the two ports' DM-RS share REs,
    separated by the OCC over each (5,6)/(12,13) time pair and
    beamformed with the SAME beam as their layer (so the UE estimates
    h_eff_l = H @ w_l per layer directly)."""
    B = layers.shape[0]
    fp = tm.fp
    # per-port (pre-beam) grids: data + OCC'd DM-RS
    pgrid = jnp.zeros((B, 2, fp.symbols_per_subframe, fp.n_fft),
                      jnp.complex64)
    for port in range(2):
        pgrid = pgrid.at[:, port, jnp.asarray(tm.data_sym),
                         jnp.asarray(tm.data_bin)].set(layers[:, port])
        for i, sym in enumerate(TM8_RS_SYMS):
            slot, lprime = divmod(i, 2)
            val = tm.rs_val[slot] * TM8_OCC[port, lprime]
            pgrid = pgrid.at[:, port, sym, jnp.asarray(tm.rs_bin)].set(
                jnp.asarray(val))
    return jnp.einsum("bpl,blsf->bpsf", beams, pgrid)


def tm8_estimate(rgrid, tm: Tm8Map, n0: float):
    """OCC despread + LMMSE comb interpolation.

    rgrid [B, ..., 14, F] (optionally a leading rx-antenna axis) ->
    h_eff [B, ..., n_data_re, 2] per-layer effective channels."""
    W = jnp.asarray(_comb_wiener(tm.fp.n_rb, tm.n_prb, float(n0),
                                 tuple(tm.rs_sc_rel.tolist())))
    hs = []
    for i, sym in enumerate(TM8_RS_SYMS):
        slot = i // 2
        ls = rgrid[..., sym, :][..., jnp.asarray(tm.rs_bin)] * \
            jnp.conj(jnp.asarray(tm.rs_val[slot]))
        hs.append(ls)
    # despread each time pair: + -> port 7, - -> port 8; average pairs
    h7 = (hs[0] + hs[1] + hs[2] + hs[3]) / 4.0
    h8 = (hs[0] - hs[1] + hs[2] - hs[3]) / 4.0
    rel = tm.data_sc - 12 * tm.rb_start
    out = []
    for h in (h7, h8):
        full = jnp.matmul(h, W, preferred_element_type=jnp.complex64)
        out.append(full[..., jnp.asarray(rel)])
    return jnp.stack(out, axis=-1)
