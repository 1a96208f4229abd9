"""Sounding Reference Signal: generation and eNB channel sounding,
36.211 §5.5.3.

Reference parity: openair1/PHY/LTE_TRANSPORT/srs_modulation.c:396
(generate_srs_tx — ZC sequence on a comb-2 over the sounded bandwidth,
last SC-FDMA symbol of the subframe) and the eNB-side wideband channel/
timing estimate it feeds (lte_eNB_measurements / srs channel estimates).

The SRS is one static frequency-domain row; sounding N UEs on
the two combs x 8 cyclic shifts is a batched conjugate-multiply + delay-
domain IDFT (matmul) — the same math as PRACH detection.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import jax.numpy as jnp

from ..config import FrameParms
from .ulref import zc_base_sequence, DFT_SIZES


@dataclass(frozen=True)
class SrsConfig:
    """One UE's SRS resource (subset of 36.211 srs-ConfigDedicated)."""
    n_rb: int                 # system bandwidth
    srs_bw_rb: int = 20       # sounded bandwidth m_SRS in RBs (even)
    rb_offset: int = 0        # k0 start RB
    k_tc: int = 0             # transmission comb {0, 1}
    n_cs: int = 0             # cyclic shift {0..7}
    u: int = 0                # sequence group

    @property
    def m_sc(self) -> int:
        """Sequence length = m_SRS * 12 / 2 (comb-2)."""
        m = self.srs_bw_rb * 6
        if m not in DFT_SIZES:
            raise ValueError(f"SRS bandwidth {self.srs_bw_rb} RB -> "
                             f"M_sc={m} not a valid ZC size")
        return m


@functools.lru_cache(maxsize=None)
def srs_sequence(cfg: SrsConfig) -> np.ndarray:
    """r_SRS(n) = e^{j alpha n} r_bar_u(n), alpha = 2 pi n_cs / 8."""
    alpha = 2.0 * np.pi * cfg.n_cs / 8.0
    n = np.arange(cfg.m_sc)
    return (np.exp(1j * alpha * n) * zc_base_sequence(cfg.u, 0, cfg.m_sc)
            ).astype(np.complex64)


@functools.lru_cache(maxsize=None)
def srs_bins(cfg: SrsConfig) -> np.ndarray:
    """FFT bins of the comb: k0 + 2n over the sounded band, centered."""
    fp = FrameParms(n_rb=cfg.n_rb)
    f0 = cfg.rb_offset * 12 - 6 * cfg.n_rb + cfg.k_tc
    f_idx = f0 + 2 * np.arange(cfg.m_sc, dtype=np.int64)
    return np.mod(f_idx, fp.n_fft).astype(np.int32)


def srs_fill_symbol(cfg: SrsConfig, batch: int, n_fft: int):
    """[B, n_fft] frequency-domain SRS symbol (last SC-FDMA symbol)."""
    row = jnp.zeros((batch, n_fft), jnp.complex64)
    return row.at[:, jnp.asarray(srs_bins(cfg))].set(
        jnp.asarray(srs_sequence(cfg)))


def srs_estimate(rx_symbol, cfg: SrsConfig):
    """eNB sounding from the received last-symbol DFT row [B, n_fft].

    Returns (H_hat [B, m_sc] LS channel over the comb,
             snr_wb [B] wideband SNR estimate,
             t_off [B] timing offset in samples, from the delay-domain peak).
    """
    bins = jnp.asarray(srs_bins(cfg))
    seq = jnp.asarray(srs_sequence(cfg))
    ls = rx_symbol[:, bins] * jnp.conj(seq)[None, :]       # [B, M]
    # delay-domain view (comb-2 => unambiguous delay range n_fft/2)
    g = jnp.fft.ifft(ls, axis=-1)
    pk = jnp.argmax(jnp.abs(g), axis=-1)
    M = ls.shape[-1]
    fp = FrameParms(n_rb=cfg.n_rb)
    # comb spacing 2 subcarriers => delay resolution n_fft/(2M) samples
    t_off = pk * fp.n_fft / (2 * M)
    t_off = jnp.where(pk > M // 2, t_off - fp.n_fft / 2, t_off)
    # wideband SNR: peak delay tap vs the noise floor of the other taps
    # (IDFT scaling: peak |g|^2 = |h|^2, noise taps have var n0/M)
    p = jnp.abs(g) ** 2
    psig = jnp.max(p, axis=-1)
    pn = (jnp.sum(p, axis=-1) - psig) / (M - 1)
    snr_db = 10.0 * jnp.log10(jnp.maximum(psig / jnp.maximum(pn * M, 1e-12),
                                          1e-9))
    return ls, snr_db, t_off
