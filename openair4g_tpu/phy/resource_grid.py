"""Downlink resource-element mapping for one subframe (36.211 §6.2/6.10).

Reference parity: openair1/PHY/LTE_TRANSPORT/dlsch_modulation.c
(allocate_REs_in_RB :139, is_not_pilot :53) and LTE_REFSIG/lte_dl_cell_spec.c.

Everything here is config-time numpy: the data/pilot RE coordinates for a
given (frame parms, n_pdcch, antenna config, subframe) are static index
arrays; on device, grid fill/extract are single gathers/scatters.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np

from ..config import FrameParms
from ..ops.gold import gold_sequence


def pilot_symbol_indices(fp: FrameParms, port: int = 0) -> tuple:
    """Symbols carrying cell-specific RS for port 0/1 within a subframe."""
    if fp.normal_cp:
        return (0, 4, 7, 11)
    return (0, 3, 6, 9)


def pilot_sc_positions(fp: FrameParms, sym: int, port: int = 0) -> np.ndarray:
    """Occupied-subcarrier indices of port-`port` pilots in symbol `sym`.

    v = 0 for port0 on slot-symbol 0, v = 3 on the mid-slot pilot symbol
    (port1 is the complement). Spacing 6, offset (v + nushift) mod 6.
    """
    l_in_slot = sym % fp.symbols_per_slot
    v = 0 if l_in_slot == 0 else 3
    if port == 1:
        v = 3 - v
    off = (v + fp.nushift) % 6
    return np.arange(off, fp.n_sc, 6, dtype=np.int32)


def pilot_values(fp: FrameParms, subframe: int, sym: int) -> np.ndarray:
    """QPSK cell-specific RS values for (subframe, symbol) per 36.211 §6.10.1.

    c_init = 2^10*(7*(ns+1)+l+1)*(2*Nid+1) + 2*Nid + N_CP.
    """
    ns = 2 * subframe + (1 if sym >= fp.symbols_per_slot else 0)
    l = sym % fp.symbols_per_slot
    ncp = 1 if fp.normal_cp else 0
    cinit = (1 << 10) * (7 * (ns + 1) + l + 1) * (2 * fp.n_id_cell + 1) \
        + 2 * fp.n_id_cell + ncp
    # 36.211: r(m) for m in [0, 2*N_RB_max); center-extract N_RB of them.
    n_rb_max = 110
    c = gold_sequence(cinit, 4 * n_rb_max).astype(np.float64)
    m = np.arange(2 * fp.n_rb) + (n_rb_max - fp.n_rb)
    re = (1 - 2 * c[2 * m]) / np.sqrt(2)
    im = (1 - 2 * c[2 * m + 1]) / np.sqrt(2)
    return (re + 1j * im).astype(np.complex64)


@dataclass(frozen=True)
class GridMap:
    """Static RE coordinates for one subframe configuration."""
    fp: FrameParms
    n_pdcch: int
    n_data_re: int
    data_sym: np.ndarray     # [n_data_re] symbol index
    data_sc: np.ndarray      # [n_data_re] occupied-subcarrier index
    data_bin: np.ndarray     # [n_data_re] FFT bin
    pilot_sym: np.ndarray    # [n_pilot] symbol index
    pilot_sc: np.ndarray
    pilot_bin: np.ndarray
    pilot_val: np.ndarray    # [n_pilot] complex64
    pilot_port: np.ndarray   # [n_pilot] antenna port of each pilot
    nports: int = 1


@functools.lru_cache(maxsize=None)
def make_grid_map(n_rb: int, n_pdcch: int, n_id_cell: int = 0,
                  subframe: int = 7, nports: int = 1,
                  normal_cp: bool = True,
                  rb_alloc: tuple | None = None) -> GridMap:
    """Data fill order matches the reference: symbols in time order, then
    subcarriers in frequency order (dlsch_modulation.c loops symbols outer).

    With nports==1 only port-0 pilots are punctured (10 data REs/RB on pilot
    symbols — get_G's SISO branch, lte_mcs.c:354); with nports==2 both port
    pilot positions are skipped (8 data REs/RB).

    rb_alloc = (rb_start, n_prb) restricts the *data* REs to a contiguous
    VRB allocation (DCI format 1A type-2); pilots stay full-band.
    """
    fp = FrameParms(n_rb=n_rb, normal_cp=normal_cp, n_id_cell=n_id_cell)
    psyms = set(pilot_symbol_indices(fp))
    if rb_alloc is None:
        k_lo, k_hi = 0, fp.n_sc
    else:
        k_lo, k_hi = rb_alloc[0] * 12, (rb_alloc[0] + rb_alloc[1]) * 12
    data_sym, data_sc = [], []
    for sym in range(n_pdcch, fp.symbols_per_subframe):
        if sym in psyms:
            skip = set(pilot_sc_positions(fp, sym, 0).tolist())
            if nports == 2:
                skip |= set(pilot_sc_positions(fp, sym, 1).tolist())
        else:
            skip = set()
        for k in range(k_lo, k_hi):
            if k not in skip:
                data_sym.append(sym)
                data_sc.append(k)
    data_sym = np.asarray(data_sym, np.int32)
    data_sc = np.asarray(data_sc, np.int32)

    pilot_sym, pilot_sc, pilot_val, pilot_port = [], [], [], []
    for sym in pilot_symbol_indices(fp):
        for port in range(nports):
            scs = pilot_sc_positions(fp, sym, port)
            vals = pilot_values(fp, subframe, sym)
            pilot_sym.append(np.full(len(scs), sym, np.int32))
            pilot_sc.append(scs)
            pilot_val.append(vals[:len(scs)])
            pilot_port.append(np.full(len(scs), port, np.int32))
    pilot_sym = np.concatenate(pilot_sym)
    pilot_sc = np.concatenate(pilot_sc)
    pilot_val = np.concatenate(pilot_val)
    pilot_port = np.concatenate(pilot_port)

    return GridMap(fp=fp, n_pdcch=n_pdcch, n_data_re=len(data_sym),
                   data_sym=data_sym, data_sc=data_sc,
                   data_bin=fp.sc_to_bin(data_sc),
                   pilot_sym=pilot_sym, pilot_sc=pilot_sc,
                   pilot_bin=fp.sc_to_bin(pilot_sc), pilot_val=pilot_val,
                   pilot_port=pilot_port, nports=nports)


def _fill_gather_idx(gm: GridMap, with_pilots: bool) -> np.ndarray:
    """[nsym*n_fft] source indices into concat([data, pilots, zero]):
    grid construction as ONE static gather instead of two scatters. The
    index array is cached ON the GridMap instance (ADVICE r4:
    an id()-keyed global dict can serve stale indices if a map is
    garbage-collected and another allocates at the same address)."""
    cache = gm.__dict__.get("_fill_idx")
    if cache is None:
        cache = {}
        object.__setattr__(gm, "_fill_idx", cache)   # frozen dataclass
    if with_pilots not in cache:
        fp = gm.fp
        nd, npi = gm.n_data_re, len(gm.pilot_sym)
        idx = np.full(fp.symbols_per_subframe * fp.n_fft,
                      nd + (npi if with_pilots else 0), np.int32)
        idx[gm.data_sym.astype(np.int64) * fp.n_fft + gm.data_bin] = \
            np.arange(nd)
        if with_pilots:
            idx[gm.pilot_sym.astype(np.int64) * fp.n_fft + gm.pilot_bin] = \
                nd + np.arange(npi)
        cache[with_pilots] = idx
    return cache[with_pilots]


def fill_grid(symbols, gm: GridMap, with_pilots: bool = True):
    """symbols [B, n_data_re] complex -> grid [B, nsym, n_fft] complex."""
    import jax.numpy as jnp
    B = symbols.shape[0]
    fp = gm.fp
    idx = _fill_gather_idx(gm, with_pilots)
    parts = [symbols]
    if with_pilots:
        pv = jnp.asarray(gm.pilot_val.astype(np.complex64))
        parts.append(jnp.broadcast_to(pv, (B, len(gm.pilot_sym))))
    parts.append(jnp.zeros((B, 1), symbols.dtype))
    src = jnp.concatenate(parts, axis=1)
    return jnp.take(src, jnp.asarray(idx), axis=1).reshape(
        B, fp.symbols_per_subframe, fp.n_fft)


def fill_grid_port(symbols, gm: GridMap, port: int):
    """Per-antenna-port grid for MIMO TX: port-`port` data + its own pilots;
    the other port's pilot REs stay zero (36.211 §6.10.1.2 — RS REs of one
    port are nulled on the others; lte_dl_cell_spec.c maps each port
    separately)."""
    import jax.numpy as jnp
    B = symbols.shape[0]
    fp = gm.fp
    grid = jnp.zeros((B, fp.symbols_per_subframe, fp.n_fft), symbols.dtype)
    grid = grid.at[:, jnp.asarray(gm.data_sym),
                   jnp.asarray(gm.data_bin)].set(symbols)
    own = gm.pilot_port == port
    pv = jnp.asarray(gm.pilot_val[own].astype(np.complex64))
    grid = grid.at[:, jnp.asarray(gm.pilot_sym[own]),
                   jnp.asarray(gm.pilot_bin[own])].set(pv)
    return grid


def extract_data_res(grid, gm: GridMap):
    """grid [B, nsym, n_fft] -> [B, n_data_re] (inverse of fill order)."""
    import jax.numpy as jnp
    return grid[:, jnp.asarray(gm.data_sym), jnp.asarray(gm.data_bin)]


def extract_pilot_res(grid, gm: GridMap):
    import jax.numpy as jnp
    return grid[:, jnp.asarray(gm.pilot_sym), jnp.asarray(gm.pilot_bin)]
