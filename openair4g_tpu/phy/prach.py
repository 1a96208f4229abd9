"""PRACH: random-access preamble generation and detection, 36.211 §5.7.

Reference parity: openair1/PHY/LTE_TRANSPORT/prach.c — NCS tables
(unrestricted/restricted/format-4, prach.c:50-52), du computation
(fill_du :374), restricted-set cyclic-shift groups (compute_prach_seq
:1640-1660), prach_ConfigIndex -> preamble format (get_prach_fmt :413),
preamble format CP/sequence timing (generate_prach :820-940 Ncp/prach_len
switch), time-domain generation through the big IDFT (:901-996) and
sample-stream detection in rx_prach (:1061).

The reference hand-writes 1536..24576-pt SIMD FFTs because its
PRACH transform sizes are odd multiples of 3. Here both directions of the
time<->839-bin mapping are ONE complex matmul against an on-device phasor
matrix built from iota (E[t,m] = exp(2pi j (k0+m) t / N), unitary pair) —
an 839xN systolic pass, no Bluestein, no power-of-2 padding.
RE-level detection (the fast path for link sims) stays a single
[B,839]x[839,839] matmul.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import jax.numpy as jnp

N_ZC = 839
N_ZC_F4 = 139           # preamble format 4 (prach.c:626)

# NCS configurations (36.211 Tables 5.7.2-2 / 5.7.2-3; prach.c:50-52),
# indexed by zeroCorrelationZoneConfig. N_CS = 0 means "no cyclic-shift
# limit": one preamble per root, the whole N_ZC window is its zone.
NCS_UNRESTRICTED = (0, 13, 15, 18, 22, 26, 32, 38, 46, 59, 76, 93, 119,
                    167, 279, 419)
NCS_RESTRICTED = (15, 18, 22, 26, 32, 38, 46, 55, 68, 82, 100, 128, 158,
                  202, 237)    # high-speed set
NCS_FORMAT4 = (2, 4, 6, 8, 10, 12, 15)

# Preamble format timing at the 30.72 Msps base rate (36.211 Table
# 5.7.1-1; the Ncp/prach_len switch in generate_prach :820-940):
# (T_CP samples, T_SEQ samples per repetition, repetitions)
FORMAT_TIMING = {
    0: (3168, 24576, 1),
    1: (21024, 24576, 1),
    2: (6240, 24576, 2),
    3: (21024, 24576, 2),
    4: (448, 4096, 1),
}


@functools.lru_cache(maxsize=None)
def zc_root(u: int, n_zc: int = N_ZC) -> np.ndarray:
    """x_u(n) = exp(-j pi u n(n+1) / N_ZC)."""
    n = np.arange(n_zc, dtype=np.float64)
    return np.exp(-1j * np.pi * u * n * (n + 1) / n_zc).astype(np.complex64)


def preamble(u: int, v: int, ncs: int, n_zc: int = N_ZC) -> np.ndarray:
    """x_{u,v}(n) = x_u((n + C_v) mod N_ZC), C_v = v * NCS (unrestricted)."""
    return np.roll(zc_root(u, n_zc), -v * ncs)


def preamble_shifted(u: int, cv: int, n_zc: int = N_ZC) -> np.ndarray:
    """x_u((n + C_v) mod N_ZC) for an explicit C_v (restricted set)."""
    return np.roll(zc_root(u, n_zc), -cv)


@functools.lru_cache(maxsize=None)
def _dft(n_zc: int = N_ZC) -> np.ndarray:
    """[n_zc, n_zc] unitary DFT matrix (host constant)."""
    n = np.arange(n_zc)
    W = np.exp(-2j * np.pi * np.outer(n, n) / n_zc) / np.sqrt(n_zc)
    return W.astype(np.complex64)


def _dft839() -> np.ndarray:        # back-compat alias
    return _dft(N_ZC)


def preamble_freq(u: int, v: int, ncs: int, n_zc: int = N_ZC) -> np.ndarray:
    """Frequency-domain preamble (what the PRACH grid carries)."""
    return (_dft(n_zc) @ preamble(u, v, ncs, n_zc)).astype(np.complex64)


@functools.lru_cache(maxsize=None)
def _root_freq_conj(u: int, n_zc: int = N_ZC) -> np.ndarray:
    return np.conj(_dft(n_zc) @ zc_root(u, n_zc)).astype(np.complex64)


def n_preambles(ncs: int, n_zc: int = N_ZC) -> int:
    """Cyclic-shift preambles available per root (unrestricted set)."""
    return n_zc // ncs if ncs else 1


# ------------------------------------------------- restricted (high-speed) --

@functools.lru_cache(maxsize=None)
def zc_du(u: int, n_zc: int = N_ZC) -> int:
    """Doppler cyclic-shift distance d_u (36.211 §5.7.2; fill_du
    prach.c:374-399): p = u^-1 mod N_ZC, d_u = min(p, N_ZC - p)."""
    p = pow(u, -1, n_zc)
    return p if p < n_zc - p else n_zc - p


def restricted_shifts(u: int, ncs: int, n_zc: int = N_ZC) -> list[int]:
    """All C_v of the restricted set for root u (36.211 §5.7.2 eq. for
    n_shift/d_start/n_group/n_shift_bar; compute_prach_seq
    prach.c:1640-1660 — note the reference's :1747 divides n_shift_bar by
    N_ZC instead of N_CS, a transcription slip against the spec; the spec
    formula is used here and only ever yields MORE preambles per root)."""
    du = zc_du(u, n_zc)
    if ncs <= du < n_zc / 3:
        n_shift = du // ncs
        d_start = 2 * du + n_shift * ncs
        n_group = n_zc // d_start
        n_shift_bar = max(0, (n_zc - 2 * du - n_group * d_start) // ncs)
    elif n_zc / 3 <= du <= (n_zc - ncs) // 2:
        n_shift = (n_zc - 2 * du) // ncs
        d_start = n_zc - 2 * du + n_shift * ncs
        n_group = du // d_start
        n_shift_bar = min(max(0, (du - n_group * d_start) // ncs), n_shift)
    else:
        return []
    total = n_shift * n_group + n_shift_bar
    return [d_start * (v // n_shift) + (v % n_shift) * ncs
            for v in range(total)] if n_shift else []


def preamble_map(root_seq_index: int, ncs_config: int,
                 high_speed: bool = False, fmt: int = 0,
                 count: int = 64) -> list[tuple[int, int]]:
    """The cell's 64 preambles as (physical root u, cyclic shift C_v),
    walking logical root indices from rootSequenceIndex (36.211 §5.7.2;
    compute_prach_seq :1690-1700). Restricted set skips roots with zero
    shifts (the not_found loop :1725)."""
    from ..tables.prach_root_map import ROOT_ORDER_0_3, ROOT_ORDER_4
    if fmt < 4:
        order, n_zc = ROOT_ORDER_0_3, N_ZC
        ncs = (NCS_RESTRICTED if high_speed
               else NCS_UNRESTRICTED)[ncs_config]
    else:
        order, n_zc = ROOT_ORDER_4, N_ZC_F4
        assert not high_speed, "format 4 has no restricted set (36.211)"
        ncs = NCS_FORMAT4[ncs_config]
    out: list[tuple[int, int]] = []
    idx = root_seq_index
    while len(out) < count:
        u = order[idx % len(order)]
        if high_speed:
            shifts = restricted_shifts(u, ncs, n_zc)
        else:
            shifts = [v * ncs for v in range(n_preambles(ncs, n_zc))]
        for cv in shifts:
            out.append((u, cv))
            if len(out) == count:
                break
        idx += 1
    return out


# --------------------------------------- prach_ConfigIndex -> occasions --

# FDD subframe patterns of 36.211 Table 5.7.1-2, indexed by
# prach_ConfigIndex % 16: (sfn_mod: 1 = any frame, 2 = even frames only,
# subframes tuple). get_prach_fmt (prach.c:413) gives fmt = idx >> 4.
_FDD_PATTERNS = (
    (2, (1,)), (2, (4,)), (2, (7,)),
    (1, (1,)), (1, (4,)), (1, (7,)),
    (1, (1, 6)), (1, (2, 7)), (1, (3, 8)),
    (1, (1, 4, 7)), (1, (2, 5, 8)), (1, (3, 6, 9)),
    (1, (0, 2, 4, 6, 8)), (1, (1, 3, 5, 7, 9)),
    (1, (0, 1, 2, 3, 4, 5, 6, 7, 8, 9)),
    (2, (9,)),
)
# patterns unavailable for formats 1/2 (Table 5.7.1-2 N/A rows) and the
# format-3 tail
_FDD_NA = {30, 46, 60, 61, 62}
_F3_REMAP = {57: 9, 58: 10, 59: 11}    # fmt3 indices 57-59 = p9-p11


def prach_fdd_config(config_index: int):
    """-> (format, sfn_mod, subframes) for an FDD prach_ConfigIndex
    (36.211 Table 5.7.1-2). Raises on N/A indices."""
    assert 0 <= config_index < 64
    if config_index in _FDD_NA:
        raise ValueError(f"prach_ConfigIndex {config_index} is N/A (FDD)")
    fmt = config_index >> 4
    p = config_index & 15
    if fmt == 3 and config_index in _F3_REMAP:
        p = _F3_REMAP[config_index]
    if fmt >= 1 and p == 14 and config_index != 14:
        raise ValueError(f"prach_ConfigIndex {config_index} is N/A (FDD)")
    sfn_mod, sfs = _FDD_PATTERNS[p]
    return fmt, sfn_mod, sfs


def is_prach_occasion(config_index: int, sfn: int, subframe: int) -> bool:
    """FDD PRACH occasion test (the reference gates prach_procedures on
    this in SCHED, via the same table)."""
    fmt, sfn_mod, sfs = prach_fdd_config(config_index)
    return (sfn % sfn_mod == 0) and subframe in sfs


# --------------------------------------------------- RE-level detection --

def prach_detect(rx_freq, u: int, ncs: int, threshold: float = 15.0,
                 n_zc: int = N_ZC, shifts: list[int] | None = None):
    """Detect preambles on the N_ZC PRACH bins.

    rx_freq: [B, n_zc] received frequency-domain PRACH (after CP removal
    and the big DFT — or directly, in an RE-level sim).
    shifts: explicit C_v list (restricted set); None = unrestricted
    grid v*ncs.
    Returns (energy [B, n_pre] per-preamble peak energy normalized by the
    noise floor, delay [B, n_pre] peak position in ZC samples, detected
    [B, n_pre] energy > threshold). The default threshold is
    ROC-calibrated by scripts/prach_roc.py (sim/prachsim.py `roc`):
    false-alarm < 1e-3/occasion with detection >= 99% at -6 dB/bin.

    corr(n) = IDFT(rx .* conj(X_u)) — one matmul; preamble v owns the
    cyclic-shift window [C_v, C_v + ncs).
    """
    win_len = ncs if ncs else n_zc          # N_CS=0: whole-root window
    if shifts is None:
        shifts = [v * ncs for v in range(n_preambles(ncs, n_zc))]
    prod = rx_freq * jnp.asarray(_root_freq_conj(u, n_zc))
    # IDFT = conj(W) @ x (unitary)
    Winv = np.conj(_dft(n_zc)).T
    corr = prod @ jnp.asarray(Winv)                      # [B, n_zc]
    e = jnp.abs(corr) ** 2
    # noise floor: mean energy (the few true peaks bias it negligibly over
    # n_zc bins)
    floor = jnp.mean(e, axis=-1, keepdims=True) + 1e-12
    # x_{u,v}(n) = x_u(n + C_v); a delay-d arrival peaks at
    # m = (d - C_v) mod N_ZC, so preamble v owns window
    # {j - C_v, j in [0, ncs)} and the in-window argmax IS the delay.
    e_wins, d_wins = [], []
    for cv in shifts:
        win = (np.arange(win_len) - cv) % n_zc           # positions of v
        ew = e[:, jnp.asarray(win)]                      # [B, ncs]
        pk = jnp.argmax(ew, axis=-1)
        e_wins.append(jnp.max(ew, axis=-1) / floor[:, 0])
        d_wins.append(pk)
    energy = jnp.stack(e_wins, axis=1)                   # [B, npre]
    delay = jnp.stack(d_wins, axis=1)
    return energy, delay, energy > threshold


# ------------------------------------------------- time-domain sample path --

def prach_samples_per_seq(n_fft: int, fmt: int) -> int:
    """Samples of one T_SEQ repetition at fs = n_fft * 15 kHz: 12*n_fft
    for Delta_f_RA = 1.25 kHz (formats 0-3), 2*n_fft for 7.5 kHz (fmt 4)."""
    return (12 if fmt < 4 else 2) * n_fft


def prach_cp_samples(n_fft: int, fmt: int) -> int:
    """T_CP at fs = n_fft * 15 kHz (the Ncp >>= switch, prach.c:860-880)."""
    base_cp, _, _ = FORMAT_TIMING[fmt]
    return (base_cp * n_fft) // 2048


def prach_k0(n_ra_prb: int, n_rb_ul: int, fmt: int) -> int:
    """First PRACH bin relative to DC in Delta_f_RA units (36.211 §5.7.3
    baseband: K*k0 + phi + K/2; the reference's k*=12; k+=13 at
    prach.c:788-794 is exactly phi + K/2 = 7 + 6 for formats 0-3)."""
    k = 12 * n_ra_prb - 6 * n_rb_ul            # 15 kHz units rel. DC
    K = 12 if fmt < 4 else 2
    phi = 7 if fmt < 4 else 2
    return K * k + phi + K // 2


def _phasor(n_fft: int, fmt: int, n_ra_prb: int, n_rb_ul: int,
            n_zc: int):
    """[N, n_zc] on-device phasor matrix E[t,m] = exp(2pi j (k0+m) t / N)
    / sqrt(N): a unitary pair (E^H E = I) so generation and detection are
    exact inverses and per-bin noise variance equals per-sample variance."""
    N = prach_samples_per_seq(n_fft, fmt)
    k0 = prach_k0(n_ra_prb, n_rb_ul, fmt)
    t = jnp.arange(N, dtype=jnp.float32)[:, None]
    m = k0 + jnp.arange(n_zc, dtype=jnp.float32)[None, :]
    return jnp.exp(2j * jnp.pi * t * m / N) / jnp.sqrt(jnp.float32(N))


def prach_time_generate(xf, n_fft: int, fmt: int, n_ra_prb: int,
                        n_rb_ul: int):
    """Frequency-domain preamble(s) [B, n_zc] -> time-domain PRACH burst
    [B, T_CP + reps*T_SEQ] at fs = n_fft*15 kHz (generate_prach
    :901-996: big IDFT + repetition + cyclic prefix)."""
    n_zc = xf.shape[-1]
    E = _phasor(n_fft, fmt, n_ra_prb, n_rb_ul, n_zc)
    s = xf @ E.T                                   # [B, N] one period
    _, _, reps = FORMAT_TIMING[fmt]
    body = jnp.concatenate([s] * reps, axis=-1)
    ncp = prach_cp_samples(n_fft, fmt)
    cp = body[:, -ncp:] if ncp <= body.shape[-1] else jnp.tile(
        body, (1, -(-ncp // body.shape[-1])))[:, -ncp:]
    return jnp.concatenate([cp, body], axis=-1)


def prach_time_to_bins(rx, n_fft: int, fmt: int, n_ra_prb: int,
                       n_rb_ul: int, n_zc: int = N_ZC):
    """Received sample stream [B, >= T_CP + reps*T_SEQ] -> [B, n_zc]
    PRACH bins (rx_prach :1061: skip CP, big DFT, extract the PRACH
    region). Repetitions (formats 2/3) average coherently (+3 dB)."""
    N = prach_samples_per_seq(n_fft, fmt)
    ncp = prach_cp_samples(n_fft, fmt)
    _, _, reps = FORMAT_TIMING[fmt]
    body = rx[:, ncp:ncp + reps * N]
    body = body.reshape(rx.shape[0], reps, N).mean(axis=1)
    E = _phasor(n_fft, fmt, n_ra_prb, n_rb_ul, n_zc)
    return body @ jnp.conj(E)                      # [B, n_zc]


def prach_time_detect(rx, n_fft: int, fmt: int, n_ra_prb: int,
                      n_rb_ul: int, u: int, ncs: int,
                      threshold: float = 15.0, n_zc: int = N_ZC,
                      shifts: list[int] | None = None):
    """Full eNB-side sample-stream detection: time -> bins -> correlator.
    Returned delay is in ZC samples; one ZC sample = N/n_zc time samples
    = (800 us / 839) * fs for formats 0-3."""
    bins = prach_time_to_bins(rx, n_fft, fmt, n_ra_prb, n_rb_ul, n_zc)
    return prach_detect(bins, u, ncs, threshold, n_zc, shifts)
