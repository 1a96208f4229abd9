"""ULSCH transport processing, UL channel estimation and SC-FDMA equalization.

Reference parity:
  - ULSCH coding: openair1/PHY/LTE_TRANSPORT/ulsch_coding.c:208 (same 36.212
    turbo chain as DLSCH; UCI multiplexing handled separately in ops/uci.py).
  - UL channel estimation: LTE_ESTIMATION/lte_ul_channel_estimation.c:55
    (DMRS conj-multiply, time-domain denoising via IDFT->window->DFT,
    slope interpolation across symbols).
  - Equalization: LTE_ESTIMATION/freq_equalization.c (per-RE LUT reciprocal
    "MMSE-ish") + SC-FDMA despread lte_idft (ulsch_demodulation.c:59).

Design:
  * Channel estimation: the reference's IDFT->window->DFT denoising IS a
    delay-domain projection — here it is one precomputed linear-MMSE matrix
    (delay prior uniform over the CP), an [B,M]x[M,M] matmul per DMRS symbol.
  * Equalization: exact per-subcarrier MMSE with closed-form post-despread
    effective SINR: rho = mean_k g_k/(1+g_k), SINR_eff = rho/(1-rho) — the
    textbook-optimal SC-FDMA receiver rather than the reference's LUT trick.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import jax
import jax.numpy as jnp

from ..config import FrameParms
from ..tables.tbs import get_TBS_UL, get_Qm_ul
from .scfdma import PuschMap, dmrs_symbol_indices

_EPS = 1e-12


@dataclass(frozen=True)
class UlschConfig:
    """Duck-type compatible with DlschConfig; DlschCodec consumes it as-is
    (the 36.212 bit chain is identical for UL-SCH data)."""
    mcs: int
    n_rb_alloc: int
    normal_cp: bool = True
    rv: int = 0
    n_turbo_iter: int = 8
    decoder_window: int | None = None   # None: ops/decoder_settings.py
    decoder_warmup: int | None = None
    g_override: int | None = None   # set when UCI steals REs (ops/uci.py)

    @property
    def tbs(self) -> int:
        return get_TBS_UL(self.mcs, self.n_rb_alloc)

    @property
    def Qm(self) -> int:
        return get_Qm_ul(self.mcs)

    @property
    def n_data_symbols(self) -> int:
        return (14 if self.normal_cp else 12) - 2   # minus 2 DMRS symbols

    @property
    def G(self) -> int:
        if self.g_override is not None:
            return self.g_override
        return self.n_data_symbols * 12 * self.n_rb_alloc * self.Qm


# ---------------------------------------------------------------------- CE --

@functools.lru_cache(maxsize=None)
def _ul_wiener_matrix(n_rb: int, n_rb_alloc: int, rb_offset: int,
                      n0: float, normal_cp: bool = True) -> np.ndarray:
    """[M, M] delay-domain LMMSE smoothing of the full-band LS estimate.

    Equivalent in intent to the reference's IDFT -> CP-window -> DFT denoise
    (lte_ul_channel_estimation.c:305-330), but as the exact MMSE projector.
    """
    fp = FrameParms(n_rb=n_rb, normal_cp=normal_cp)
    m_sc = 12 * n_rb_alloc
    f_idx = rb_offset * 12 + np.arange(m_sc) - 6 * n_rb
    L = fp.cp + 2
    taps = np.arange(L)
    F = np.exp(-2j * np.pi * f_idx[:, None] * taps[None, :] / fp.n_fft)
    P = 1.0 / L
    A = (F * P) @ F.conj().T + n0 * np.eye(m_sc)
    W = (F * P) @ F.conj().T @ np.linalg.inv(A)     # [M, M]
    return W.T.astype(np.complex64)                  # ls @ W


@functools.lru_cache(maxsize=None)
def _ul_time_weights(data_syms: tuple, normal_cp: bool = True,
                     hopped: bool = False) -> np.ndarray:
    """[n_data_sym, 2] linear interpolation weights between the two DMRS
    symbols (clamped outside — the reference extrapolates by slope, which
    amplifies noise at the subframe edges; clamping is the stabler choice
    and is what its low-Doppler mode converges to). With PUSCH frequency
    hopping the two slots sit at different PRBs, so cross-slot
    interpolation is invalid: each slot uses only its own DMRS (step
    weights)."""
    fp = FrameParms(n_rb=6, normal_cp=normal_cp)   # symbol layout only
    d0, d1 = dmrs_symbol_indices(fp)
    half = fp.symbols_per_subframe // 2
    Wt = np.zeros((len(data_syms), 2), np.float32)
    for i, l in enumerate(data_syms):
        if hopped:
            Wt[i] = (1.0, 0.0) if l < half else (0.0, 1.0)
        else:
            t = np.clip((l - d0) / (d1 - d0), 0.0, 1.0)
            Wt[i] = (1.0 - t, t)
    return Wt


def make_ul_wiener(pm: PuschMap, n0: float) -> np.ndarray:
    """Host precompute of the [M, M] complex64 smoothing matrix for one
    noise level; passed to the jitted step as a device argument so an SNR
    sweep reuses a single compiled program."""
    return _ul_wiener_matrix(pm.fp.n_rb, pm.n_rb_alloc, pm.rb_offset,
                             float(n0), pm.fp.normal_cp).astype(np.complex64)


def ul_estimate_channel(dmrs_rx, dmrs_ref: np.ndarray, pm: PuschMap, wiener):
    """dmrs_rx [B, 2, M] -> H_hat [B, n_data_sym, M].

    LS per DMRS symbol (conj-reference multiply), delay-domain LMMSE
    smoothing (`wiener` from make_ul_wiener), linear time interpolation onto
    the data symbols.
    """
    W = jnp.asarray(wiener)
    ls = dmrs_rx * jnp.asarray(np.conj(dmrs_ref))[None, None, :]
    # HIGHEST: the float32 matmuls must not run in TF32 on a GPU
    h = jnp.matmul(ls, W, preferred_element_type=jnp.complex64,
                   precision=jax.lax.Precision.HIGHEST)          # [B, 2, M]
    Wt = jnp.asarray(_ul_time_weights(tuple(pm.data_syms.tolist()),
                                      pm.fp.normal_cp,
                                      pm.hopped))                # [C, 2]
    return jnp.einsum("cp,bpm->bcm", Wt, h,
                      precision=jax.lax.Precision.HIGHEST)


# --------------------------------------------------------------- equalizer --

def scfdma_mmse_equalize(y, H, n0):
    """Per-subcarrier MMSE for DFT-spread OFDM, with exact post-despread
    effective noise.

    y, H: [B, C, M] (frequency domain, per data symbol). Returns
    (xf_eq [B, C, M] frequency-domain MMSE-filtered and bias-corrected
    symbols ready for the unitary IDFT, n0_eff [B, C, 1]).
    """
    h2 = (H * jnp.conj(H)).real
    g = h2 / n0                                       # per-SC SNR
    mmse = jnp.conj(H) / (h2 + n0)                    # MMSE filter
    rho = jnp.mean(g / (1.0 + g), axis=-1, keepdims=True)
    rho = jnp.maximum(rho, _EPS)
    xf = y * mmse / rho
    n0_eff = (1.0 - rho) / rho                        # unit-energy symbols
    return xf, jnp.maximum(n0_eff, _EPS)
