"""SC-FDMA (PUSCH) modulation: transform precoding + RE mapping, 36.211 §5.6.

Reference parity:
  - transform precoding: openair1/PHY/LTE_TRANSPORT/ulsch_modulation.c:53
    (dft_lte — batched 12..1200-pt DFT spread) and despreading lte_idft
    (ulsch_demodulation.c:59).
  - RE map: ulsch_modulation.c:376 (data symbols, DMRS on slot symbol 3).
  - 7.5 kHz half-subcarrier shift: MODULATION/ul_7_5_kHz.c:45/152.

The M_sc-point DFT/IDFT is a precomputed unitary DFT matrix
matmul [.., M] x [M, M] — matmul work, one code path for every 2^a*3^b*5^c
size (the reference needs a 16k-line mixed-radix kernel zoo for these).
The channel interleaver (36.212 §5.2.2.8, data-only case) is a static
permutation fused into the symbol->grid gather.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import jax
import jax.numpy as jnp

from ..config import FrameParms


@functools.lru_cache(maxsize=None)
def _dft_mat(m: int) -> np.ndarray:
    n = np.arange(m)
    w = np.exp(-2j * np.pi * np.outer(n, n) / m) / np.sqrt(m)
    return w.astype(np.complex64)


def transform_precode(x):
    """Unitary M-point DFT along the last axis (DFT-spread OFDM)."""
    # HIGHEST: the float32 DFT matmul must not run in TF32 on a GPU
    return jnp.matmul(x, jnp.asarray(_dft_mat(x.shape[-1])),
                      preferred_element_type=jnp.complex64,
                      precision=jax.lax.Precision.HIGHEST)


def transform_deprecode(x):
    """Unitary M-point IDFT along the last axis (despread)."""
    return jnp.matmul(x, jnp.asarray(_dft_mat(x.shape[-1]).conj().T),
                      preferred_element_type=jnp.complex64,
                      precision=jax.lax.Precision.HIGHEST)


def dmrs_symbol_indices(fp: FrameParms) -> tuple:
    """SC-FDMA symbols carrying PUSCH DMRS (36.211 Table 5.5.2.1.1-2):
    symbol 3 of each slot for normal CP, symbol 2 for extended."""
    l = 3 if fp.normal_cp else 2
    return (l, l + fp.symbols_per_slot)


@dataclass(frozen=True)
class PuschMap:
    """Static RE/interleaver maps for one PUSCH allocation. With PUSCH
    frequency hopping (36.211 §5.3.4) the second slot sits at
    `rb_offset2`; per-symbol bin tables carry the hop."""
    fp: FrameParms
    n_rb_alloc: int
    rb_offset: int
    m_sc: int
    data_syms: np.ndarray    # [n_data_sym] SC-FDMA symbol indices
    dmrs_syms: np.ndarray    # [2]
    sc_bins: np.ndarray      # [m_sc] FFT bins (slot 0 / unhopped)
    interleave: np.ndarray   # [n_mod_sym] perm: time-interleaved -> serial
    rb_offset2: int = None   # second-slot PRB start (hopping); None = same
    sc_bins_sym: np.ndarray = None   # [n_data_sym, m_sc] per-symbol bins
    dmrs_bins: np.ndarray = None     # [2, m_sc] per-DMRS-symbol bins

    @property
    def hopped(self) -> bool:
        return self.rb_offset2 is not None and \
            self.rb_offset2 != self.rb_offset


@functools.lru_cache(maxsize=None)
def make_pusch_map(n_rb: int, n_rb_alloc: int, rb_offset: int = 0,
                   normal_cp: bool = True, srs: bool = False,
                   rb_offset2: int | None = None) -> PuschMap:
    """srs=True vacates the last SC-FDMA symbol for the sounding RS
    (36.211 §5.5.3; the reference shortens Nsymb_pusch the same way).
    rb_offset2: second-slot PRB start for intra-subframe frequency
    hopping (phy/hopping.pusch_hopped_rb_start)."""
    fp = FrameParms(n_rb=n_rb, normal_cp=normal_cp)
    m_sc = 12 * n_rb_alloc
    dmrs = dmrs_symbol_indices(fp)
    skip = set(dmrs) | ({fp.symbols_per_subframe - 1} if srs else set())
    data_syms = np.asarray([s for s in range(fp.symbols_per_subframe)
                            if s not in skip], np.int32)
    # UL subcarriers are contiguous (no DC puncture — the real grid sits at a
    # half-subcarrier offset via the 7.5 kHz shift); map them symmetrically
    # around bin 0.
    def bins_at(off):
        f_idx = off * 12 + np.arange(m_sc, dtype=np.int64) - 6 * n_rb
        return np.mod(f_idx, fp.n_fft).astype(np.int32)
    sc_bins = bins_at(rb_offset)
    off2 = rb_offset if rb_offset2 is None else rb_offset2
    bins2 = bins_at(off2)
    half = fp.symbols_per_subframe // 2
    sc_bins_sym = np.stack([sc_bins if l < half else bins2
                            for l in data_syms])
    dmrs_bins = np.stack([sc_bins if l < half else bins2 for l in dmrs])
    # 36.212 §5.2.2.8 channel interleaver, data-only: an (Rmux x Cmux) matrix
    # with Cmux = n_data_sym columns is written row-major in Qm-bit symbols
    # and read column-major; combined with the k-then-l grid mapping this
    # sends consecutive modulation symbols down the time axis first. As a
    # symbol-level permutation: serial index i lands at (sym, sc) =
    # (i % C, i // C); we store the inverse gather for [nsym, m_sc] layout.
    C = len(data_syms)
    idx = np.arange(C * m_sc).reshape(m_sc, C).T.reshape(-1)  # [sym, sc] <- i
    return PuschMap(fp=fp, n_rb_alloc=n_rb_alloc, rb_offset=rb_offset,
                    m_sc=m_sc, data_syms=data_syms,
                    dmrs_syms=np.asarray(dmrs, np.int32),
                    sc_bins=sc_bins, interleave=idx.astype(np.int32),
                    rb_offset2=off2, sc_bins_sym=sc_bins_sym,
                    dmrs_bins=dmrs_bins)


def pusch_fill_grid(sym, pm: PuschMap, dmrs_val: np.ndarray):
    """sym [B, n_mod_sym] complex (serial order) -> grid [B, nsym, n_fft].

    Applies the channel interleaver, transform-precodes each SC-FDMA data
    symbol, and writes DMRS on the two pilot symbols.
    """
    B = sym.shape[0]
    C, M = len(pm.data_syms), pm.m_sc
    x = sym[:, jnp.asarray(pm.interleave)].reshape(B, C, M)
    return pusch_fill_grid_x(x, pm, dmrs_val)


def pusch_fill_grid_x(x, pm: PuschMap, dmrs_val: np.ndarray):
    """x [B, C, M] pre-interleaved modulation symbols (e.g. from
    ops/uci.uci_multiplex) -> grid [B, nsym, n_fft]."""
    B = x.shape[0]
    fp = pm.fp
    C, M = len(pm.data_syms), pm.m_sc
    xf = transform_precode(x)
    grid = jnp.zeros((B, fp.symbols_per_subframe, fp.n_fft), jnp.complex64)
    grid = grid.at[:, jnp.asarray(pm.data_syms)[:, None],
                   jnp.asarray(pm.sc_bins_sym)].set(xf)
    dm = jnp.asarray(dmrs_val.astype(np.complex64))
    grid = grid.at[:, jnp.asarray(pm.dmrs_syms)[:, None],
                   jnp.asarray(pm.dmrs_bins)].set(
        jnp.broadcast_to(dm, (B, 2, M)))
    return grid


def pusch_extract(grid, pm: PuschMap):
    """grid [B, nsym, n_fft] -> (data [B, C, M], dmrs [B, 2, M])."""
    data = grid[:, jnp.asarray(pm.data_syms)[:, None],
                jnp.asarray(pm.sc_bins_sym)]
    dmrs = grid[:, jnp.asarray(pm.dmrs_syms)[:, None],
                jnp.asarray(pm.dmrs_bins)]
    return data, dmrs


def pusch_deinterleave(x_time, pm: PuschMap):
    """x_time [B, C, M] despread symbols -> serial order [B, n_mod_sym]."""
    B = x_time.shape[0]
    flat = x_time.reshape(B, -1)
    inv = np.empty_like(pm.interleave)
    inv[pm.interleave] = np.arange(len(pm.interleave), dtype=np.int32)
    return flat[:, jnp.asarray(inv)]


@functools.lru_cache(maxsize=None)
def _half_sc_phasor(n_rb: int, normal_cp: bool = True) -> np.ndarray:
    """e^{j pi t / n_fft} over one subframe: the +7.5 kHz half-subcarrier
    shift of SC-FDMA (ul_7_5_kHz.c applies the same per-sample table)."""
    fp = FrameParms(n_rb=n_rb, normal_cp=normal_cp)
    t = np.arange(fp.samples_per_tti)
    return np.exp(1j * np.pi * t / fp.n_fft).astype(np.complex64)


def apply_7_5_khz(t_samples, fp: FrameParms):
    return t_samples * jnp.asarray(_half_sc_phasor(fp.n_rb, fp.normal_cp))


def remove_7_5_khz(t_samples, fp: FrameParms):
    return t_samples * jnp.conj(
        jnp.asarray(_half_sc_phasor(fp.n_rb, fp.normal_cp)))
