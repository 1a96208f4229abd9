"""PSS/SSS generation and cell search (36.211 §6.11).

Reference parity:
  openair1/PHY/LTE_TRANSPORT/pss.c:50 (generate_pss — ZC62 into center REs),
  sss.c:222 (rx_sss — PSS-coherent SSS detection -> Nid_cell),
  openair1/PHY/LTE_ESTIMATION/lte_sync_time.c:357 (lte_sync_time — PSS
  time-domain matched filter over a half frame, 3 replicas).

The reference slides a SIMD dot_product at 1/4-sample stride;
here the matched filter is one FFT-domain correlation over the whole 5 ms
capture for all 3 Nid2 replicas at once (overlap-free: single big FFT),
batched over trials — the O(N·L) scan becomes O(N log N).
SSS detection correlates the PSS-equalized SSS REs against all 336
(Nid1, half-frame) hypotheses with one [B,62]x[62,336] matmul.
"""
from __future__ import annotations

import functools

import numpy as np
import jax.numpy as jnp

from ..config import FrameParms

_PSS_ROOTS = (25, 29, 34)   # Nid2 0/1/2 (36.211 Table 6.11.1.1-1)


@functools.lru_cache(maxsize=None)
def pss_sequence(nid2: int) -> np.ndarray:
    """ZC62 PSS d_u(n), n=0..61 (36.211 §6.11.1.1)."""
    u = _PSS_ROOTS[nid2]
    n = np.arange(62)
    ph = np.where(n < 31, n * (n + 1), (n + 1) * (n + 2))
    return np.exp(-1j * np.pi * u * ph / 63.0).astype(np.complex64)


def _m_seq(taps) -> np.ndarray:
    """Length-31 m-sequence 1-2x with x(0..4)=(0,0,0,0,1), x(i+5)=sum taps."""
    x = np.zeros(31, np.int64)
    x[4] = 1
    for i in range(26):
        x[i + 5] = sum(x[i + t] for t in taps) % 2
    return (1 - 2 * x).astype(np.float64)


@functools.lru_cache(maxsize=None)
def _sss_bases():
    s = _m_seq((2, 0))       # x(i+5) = x(i+2) + x(i)
    c = _m_seq((3, 0))       # x(i+5) = x(i+3) + x(i)
    z = _m_seq((4, 2, 1, 0))  # x(i+5) = x(i+4)+x(i+2)+x(i+1)+x(i)
    return s, c, z


def _m0_m1(nid1: int) -> tuple:
    qp = nid1 // 30
    q = (nid1 + qp * (qp + 1) // 2) // 30
    mp = nid1 + q * (q + 1) // 2
    m0 = mp % 31
    m1 = (m0 + mp // 31 + 1) % 31
    return m0, m1


@functools.lru_cache(maxsize=None)
def sss_sequence(nid1: int, nid2: int, second_half: bool) -> np.ndarray:
    """SSS d(0..61) for subframe 0 (False) / subframe 5 (True)."""
    s, c, z = _sss_bases()
    m0, m1 = _m0_m1(nid1)
    n = np.arange(31)
    c0 = c[(n + nid2) % 31]
    c1 = c[(n + nid2 + 3) % 31]
    if not second_half:
        even = s[(n + m0) % 31] * c0
        odd = s[(n + m1) % 31] * c1 * z[(n + (m0 % 8)) % 31]
    else:
        even = s[(n + m1) % 31] * c0
        odd = s[(n + m0) % 31] * c1 * z[(n + (m1 % 8)) % 31]
    d = np.empty(62, np.float64)
    d[0::2] = even
    d[1::2] = odd
    return d.astype(np.complex64)


def center62_grid_sc(fp: FrameParms) -> np.ndarray:
    """Occupied-grid subcarrier indices of the 62 sync REs (d(n) order)."""
    return (6 * fp.n_rb - 31 + np.arange(62)).astype(np.int32)


def center62_bins(fp: FrameParms) -> np.ndarray:
    return fp.sc_to_bin(center62_grid_sc(fp))


@functools.lru_cache(maxsize=None)
def pss_time_replica(nid2: int, n_fft: int) -> np.ndarray:
    """Unit-energy time-domain PSS symbol (no CP) at FFT size n_fft."""
    fp_bins_pos = np.arange(1, 32)
    fp_bins_neg = n_fft - 31 + np.arange(31)
    f = np.zeros(n_fft, np.complex128)
    d = pss_sequence(nid2)
    f[fp_bins_neg] = d[:31]
    f[fp_bins_pos] = d[31:]
    t = np.fft.ifft(f, norm="ortho")
    return (t / np.linalg.norm(t)).astype(np.complex64)


class CellSearch:
    """PSS timing + Nid2 detection and SSS Nid1/half-frame detection.

    Matches initial_sync's structure (LTE_TRANSPORT/initial_sync.c:274) for
    one (FDD, CP) hypothesis; all trials are batched.
    """

    def __init__(self, fp: FrameParms, capture_len: int | None = None):
        self.fp = fp
        # 5 ms half-frame capture plus one symbol of margin
        self.capture_len = capture_len or (5 * fp.samples_per_tti + fp.n_fft)
        L = self.capture_len
        # zero-pad the correlation FFT to a power-of-2 length
        self._fft_len = 1 << (L - 1).bit_length()
        reps = np.stack([pss_time_replica(i, fp.n_fft) for i in range(3)])
        pad = np.zeros((3, self._fft_len - fp.n_fft), np.complex64)
        self._rep_f = np.fft.fft(
            np.concatenate([reps, pad], axis=1), axis=1).astype(np.complex64)
        # SSS hypothesis bank: [62, 336] (nid1-major, then half-frame flag)
        self._nid2_banks = []
        for nid2 in range(3):
            cols = []
            for half in (False, True):
                for nid1 in range(168):
                    cols.append(sss_sequence(nid1, nid2, half))
            self._nid2_banks.append(
                np.stack(cols, axis=1).astype(np.complex64))   # [62, 336]
        self._bins = center62_bins(fp)

    def pss_correlate(self, r):
        """r [B, L] complex -> (peak_pos [B], nid2 [B], corr_energy [B,3,L]).

        FFT cross-correlation: corr[t] = sum_n conj(p[n]) r[t+n].
        """
        L = self.capture_len
        rf = jnp.fft.fft(r, n=self._fft_len, axis=-1)          # [B, fft_len]
        corr = jnp.fft.ifft(rf[:, None, :] * jnp.asarray(np.conj(self._rep_f)),
                            axis=-1)[..., :L]                  # [B, 3, L]
        e = jnp.abs(corr) ** 2
        # restrict peaks to positions with a full symbol after them
        valid = L - self.fp.n_fft
        e_valid = e[..., :valid]
        flat = e_valid.reshape(e.shape[0], -1)
        am = jnp.argmax(flat, axis=-1)
        nid2 = am // valid
        pos = am % valid
        self._last_peak = jnp.max(flat, axis=-1)
        return pos, nid2, corr

    def _extract62(self, r, start):
        """FFT the symbol starting at `start` (per-trial) and take 62 REs."""
        n_fft = self.fp.n_fft
        idx = start[:, None] + jnp.arange(n_fft)[None, :]
        sym = jnp.take_along_axis(r, idx, axis=-1)
        f = jnp.fft.fft(sym, axis=-1, norm="ortho")
        return f[:, jnp.asarray(self._bins)]

    def sss_detect(self, r, pss_pos, nid2):
        """Coherent SSS detection. Returns (nid1 [B], half [B] in {0,1}).

        SSS sits one symbol before PSS (FDD): start = pss_pos - (n_fft+cp).
        Channel from PSS LS estimate; decision = argmax over the 336-column
        hypothesis matmul of the equalized SSS.
        """
        fp = self.fp
        pss_rx = self._extract62(r, pss_pos)
        sss_start = pss_pos - (fp.n_fft + fp.cp)
        sss_rx = self._extract62(r, sss_start)
        banks = jnp.asarray(np.stack(self._nid2_banks))        # [3, 62, 336]
        pss_refs = jnp.stack(
            [jnp.asarray(pss_sequence(i)) for i in range(3)])  # [3, 62]
        ch = pss_rx * jnp.conj(pss_refs[nid2])                 # [B, 62] LS est
        z = sss_rx * jnp.conj(ch)                              # equalized SSS
        bank = banks[nid2]                                     # [B, 62, 336]
        scores = jnp.einsum("bk,bkh->bh", z, bank.astype(z.dtype)).real
        best = jnp.argmax(scores, axis=-1)
        return best % 168, best // 168

    def search(self, r):
        """Full cell search on [B, L] captures.

        Returns dict(pss_pos, nid2, nid1, half, nid_cell).
        """
        pos, nid2, _ = self.pss_correlate(r)
        nid1, half = self.sss_detect(r, pos, nid2)
        return dict(pss_pos=pos, nid2=nid2, nid1=nid1, half=half,
                    nid_cell=3 * nid1 + nid2, peak=self._last_peak)


def estimate_cfo(r, pss_pos, nid2, n_fft: int):
    """Fractional CFO estimate from the PSS symbol's two halves.

    The ZC symbol's halves differ only by the channel + CFO rotation:
    angle(<conj(h1·p1), h2·p2>) ~= pi * f_off / f_scs. Returns CFO in
    subcarrier-spacing units [B].
    """
    idx = pss_pos[:, None] + jnp.arange(n_fft)[None, :]
    sym = jnp.take_along_axis(r, idx, axis=-1)
    reps = jnp.stack([jnp.asarray(pss_time_replica(i, n_fft))
                      for i in range(3)])
    p = reps[nid2]
    y = sym * jnp.conj(p)
    h = n_fft // 2
    c = jnp.sum(jnp.conj(y[:, :h]) * y[:, h:], axis=-1)
    return jnp.angle(c) / jnp.pi
