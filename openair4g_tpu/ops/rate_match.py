"""Rate matching for turbo-coded transport channels, 3GPP TS 36.212 §5.1.4.1.

Reference parity: openair1/PHY/CODING/lte_rate_matching.c
(sub_block_interleaving_turbo :51, generate_dummy_w :293,
lte_rate_matching_turbo :464, lte_rate_matching_turbo_rx :688).

Design: the whole sub-block-interleave -> circular-buffer ->
bit-selection pipeline is data-independent given (K, F, rv, E, Ncb), so it is
precomputed on the host as index maps once per configuration:

  * TX: one gather  e = d_flat[e_src]            (E indices into the 3 streams)
  * RX: NO scatter. The circular buffer emits the L non-NULL positions of w
    cyclically, so the E received LLRs fold onto a length-L "order space"
    buffer by a zero-pad + [reps, L] reshape + sum (repetition combining),
    followed by a static roll of r_off (the rv-dependent start k0 is just a
    rotation of the same non-NULL sequence). HARQ rounds accumulate into that
    persistent order-space buffer (the reference's harq_process->w soft
    combining, dlsch_decoding.c:350) — all reshapes/rolls instead of a
    scatter-add.
  * order space -> d streams: one static gather (d_from_order).

NULL positions (dummy padding + filler bits in streams 0/1) are never indexed.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np

# 36.212 Table 5.1.4-1 inter-column permutation pattern for C_TC = 32.
PERM32 = np.array([0, 16, 8, 24, 4, 20, 12, 28, 2, 18, 10, 26, 6, 22, 14, 30,
                   1, 17, 9, 25, 5, 21, 13, 29, 3, 19, 11, 27, 7, 23, 15, 31],
                  np.int32)

NSOFT_DEFAULT = 1827072  # UE category 3 soft buffer (LTE_TRANSPORT/defs.h:62)


@functools.lru_cache(maxsize=None)
def _w_maps(D: int, F: int):
    """Sub-block interleaver maps for stream length D with F filler bits.

    Returns (w_src [3*Kpi] int32 index into d_flat[3*D] or -1 for NULL,
             Kpi).
    w layout: w[0:Kpi] = v0; w[Kpi + 2j] = v1[j]; w[Kpi + 2j + 1] = v2[j].
    """
    R = -(-D // 32)
    Kpi = 32 * R
    ND = Kpi - D

    k = np.arange(Kpi)
    c, r = k // R, k % R
    # streams 0/1: v[k] = y[r*32 + PERM32[c]], y = [ND nulls | d]
    y01 = r * 32 + PERM32[c]
    # stream 2: v2[k] = y[(PERM32[k//R] + 32*(k%R) + 1) mod Kpi]
    y2 = (PERM32[c] + 32 * r + 1) % Kpi

    def to_src(ypos: np.ndarray, stream: int, has_filler_null: bool):
        dpos = ypos - ND
        valid = dpos >= 0
        if has_filler_null:
            valid &= dpos >= F
        return np.where(valid, stream * D + dpos, -1).astype(np.int32)

    v0 = to_src(y01, 0, True)
    v1 = to_src(y01, 1, True)
    v2 = to_src(y2, 2, False)

    w_src = np.empty(3 * Kpi, np.int32)
    w_src[:Kpi] = v0
    w_src[Kpi::2] = v1
    w_src[Kpi + 1::2] = v2
    return w_src, Kpi


def compute_ncb(K: int, C: int, *, nsoft: int = NSOFT_DEFAULT, kmimo: int = 1,
                mdl_harq: int = 8, downlink: bool = True) -> int:
    """Soft buffer size per code block (36.212 §5.1.4.1.2)."""
    D = K + 4
    Kw = 3 * (32 * (-(-D // 32)))
    if not downlink:
        return Kw
    nir = nsoft // (kmimo * min(mdl_harq, 8))
    return min(nir // C, Kw)


def block_e_sizes(G: int, C: int, Qm: int, Nl: int = 1) -> list:
    """Per-code-block rate-matching output sizes E (36.212 §5.1.4.1.2)."""
    Gp = G // (Nl * Qm)
    gamma = Gp % C
    e_small = Nl * Qm * (Gp // C)
    e_big = Nl * Qm * (-(-Gp // C))
    return [e_small if r <= C - 1 - gamma else e_big for r in range(C)]


@dataclass(frozen=True)
class RateMatchMaps:
    """Static index maps for one (K, F, rv, E) rate-matching configuration."""
    K: int
    F: int
    rv: int
    E: int
    Ncb: int
    Kw: int                 # 3 * Kpi = full circular buffer length
    L: int                  # non-NULL positions within Ncb (order-space size)
    r_off: int              # this rv's rotation within the base emit order
    e_to_w: np.ndarray      # [E] int32: w position of each transmitted bit
    e_src: np.ndarray       # [E] int32: index into d_flat [3*(K+4)] (TX gather)
    w_of_d: np.ndarray      # [3*(K+4)] int32: w position of each d bit, -1 if
                            # that d position is never in w (fillers/nulls)
    d_from_order: np.ndarray  # [3*(K+4)] int32: order-space index of each d
                              # bit, -1 if never transmitted (fillers/Ncb cap)


@functools.lru_cache(maxsize=None)
def make_rate_match_maps(K: int, F: int, rv: int, E: int,
                         Ncb: int | None = None) -> RateMatchMaps:
    D = K + 4
    w_src, Kpi = _w_maps(D, F)
    Kw = 3 * Kpi
    if Ncb is None:
        Ncb = Kw
    R = Kpi // 32

    # k0 per 36.212: R*(2*ceil(Ncb/(8R))*rv + 2)
    k0 = R * (2 * (-(-Ncb // (8 * R))) * rv + 2)

    cyc = (k0 + np.arange(Ncb)) % Ncb
    valid = w_src[cyc] >= 0
    order = cyc[valid]                     # non-NULL w positions in emit order
    reps = -(-E // len(order))
    e_to_w = np.tile(order, reps)[:E].astype(np.int32)
    e_src = w_src[e_to_w]

    w_of_d = np.full(3 * D, -1, np.int32)
    nonnull = w_src >= 0
    w_of_d[w_src[nonnull]] = np.nonzero(nonnull)[0].astype(np.int32)

    # Base (rv-independent) emit order = non-NULL positions of [0, Ncb) in
    # increasing w order; every rv's order is that sequence rotated by r_off.
    order_base = np.nonzero(w_src[:Ncb] >= 0)[0]
    L = len(order_base)
    r_off = int(np.searchsorted(order_base, k0 % Ncb))
    # order-space index of each d position (inverse of d = w_src[order_base])
    d_from_order = np.full(3 * D, -1, np.int32)
    d_from_order[w_src[order_base]] = np.arange(L, dtype=np.int32)
    return RateMatchMaps(K=K, F=F, rv=rv, E=E, Ncb=Ncb, Kw=Kw, L=L,
                         r_off=r_off, e_to_w=e_to_w, e_src=e_src,
                         w_of_d=w_of_d, d_from_order=d_from_order)


@dataclass(frozen=True)
class CCRateMatchMaps:
    """Index maps for convolutionally-coded channels (36.212 §5.1.4.2)."""
    D: int
    E: int
    Kw: int
    L: int                  # non-NULL circular-buffer length
    e_src: np.ndarray       # [E] int32 into d_flat [3*D] (TX gather)
    e_to_w: np.ndarray      # [E] int32 w position (kept for goldens)
    w_of_d: np.ndarray      # [3*D] int32 w position of each d bit
    d_from_order: np.ndarray  # [3*D] int32 order-space index of each d bit


@functools.lru_cache(maxsize=None)
def make_cc_rate_match_maps(D: int, E: int) -> CCRateMatchMaps:
    """CC sub-block interleaver + circular buffer (reference parity:
    lte_rate_matching_cc / sub_block_interleaving_cc,
    lte_rate_matching.c:133,637 — same PERM32 for all three streams,
    w = [v0|v1|v2] concatenated, k0 = 0, NULLs skipped)."""
    R = -(-D // 32)
    Kpi = 32 * R
    ND = Kpi - D
    k = np.arange(Kpi)
    c, r = k // R, k % R
    ypos = r * 32 + PERM32[c]
    dpos = ypos - ND
    v = np.where(dpos >= 0, dpos, -1).astype(np.int32)   # same for each stream

    Kw = 3 * Kpi
    w_src = np.concatenate([np.where(v >= 0, s * D + v, -1)
                            for s in range(3)]).astype(np.int32)
    cyc = np.arange(Kw) % Kw
    valid = w_src[cyc] >= 0
    order = cyc[valid]
    reps = -(-E // len(order))
    e_to_w = np.tile(order, reps)[:E].astype(np.int32)
    e_src = w_src[e_to_w]

    w_of_d = np.full(3 * D, -1, np.int32)
    nonnull = w_src >= 0
    w_of_d[w_src[nonnull]] = np.nonzero(nonnull)[0].astype(np.int32)

    order_base = np.nonzero(w_src >= 0)[0]        # k0 = 0 for CC channels
    L = len(order_base)
    d_from_order = np.full(3 * D, -1, np.int32)
    d_from_order[w_src[order_base]] = np.arange(L, dtype=np.int32)
    return CCRateMatchMaps(D=D, E=E, Kw=Kw, L=L, e_src=e_src, e_to_w=e_to_w,
                           w_of_d=w_of_d, d_from_order=d_from_order)


def cc_rate_match_tx(d_flat, maps: CCRateMatchMaps):
    """d_flat [B, 3*D] -> e [B, E]."""
    import jax.numpy as jnp
    return d_flat[:, jnp.asarray(maps.e_src)]


def cc_rate_match_rx(e_llr, maps: CCRateMatchMaps):
    """e_llr [B, E] -> d stream LLRs [B, 3, D] (repetition soft-combined).

    Scatter-free: zero-pad to reps*L + reshape-sum folds repetitions (PBCH
    repeats the 120-bit buffer 16x), then one static gather back to d order.
    """
    import jax.numpy as jnp
    B, E = e_llr.shape
    L = maps.L
    reps = -(-E // L)
    if reps * L != E:
        e_llr = jnp.concatenate(
            [e_llr, jnp.zeros((B, reps * L - E), e_llr.dtype)], axis=1)
    folded = e_llr.reshape(B, reps, L).sum(axis=1) if reps > 1 \
        else e_llr.reshape(B, L)
    idx = jnp.asarray(np.where(maps.d_from_order >= 0, maps.d_from_order, 0))
    mask = jnp.asarray((maps.d_from_order >= 0).astype(np.float32))
    return (folded[:, idx] * mask).reshape(B, 3, maps.D)


def rate_match_tx(d_flat, maps: RateMatchMaps):
    """d_flat [B, 3*(K+4)] -> e [B, E]. One gather."""
    import jax.numpy as jnp
    return d_flat[:, jnp.asarray(maps.e_src)]


def rate_match_rx(e_llr, maps: RateMatchMaps, w_soft=None):
    """e_llr [B, E] -> order-space soft buffer [B, L].

    No scatter: repetition combining is a zero-pad to reps*L + [B, reps, L]
    reshape + sum, and the rv-dependent circular-buffer start k0 is a static
    roll by r_off. Passing a previous round's `w_soft` (any rv) implements
    HARQ soft combining — all rounds share the same base order space.
    """
    import jax.numpy as jnp
    B, E = e_llr.shape
    L = maps.L
    reps = -(-E // L)
    if reps * L != E:
        e_llr = jnp.concatenate(
            [e_llr, jnp.zeros((B, reps * L - E), e_llr.dtype)], axis=1)
    folded = e_llr.reshape(B, reps, L).sum(axis=1) if reps > 1 \
        else e_llr.reshape(B, L)
    contrib = jnp.roll(folded, maps.r_off, axis=1)
    return contrib if w_soft is None else w_soft + contrib


def w_to_d_llr(w_soft, maps: RateMatchMaps, filler_big: float = 1e4):
    """order-space w_soft [B, L] -> d stream LLRs [B, 3, K+4].

    One static gather. Filler positions (known zero bits, streams 0/1) get
    +filler_big; d positions never transmitted (NULLs / Ncb cap) keep LLR 0.
    """
    import jax.numpy as jnp
    D = maps.K + 4
    idx = jnp.asarray(np.where(maps.d_from_order >= 0, maps.d_from_order, 0))
    vals = w_soft[:, idx]
    mask = jnp.asarray((maps.d_from_order >= 0).astype(np.float32))
    d_llr = (vals * mask).reshape(-1, 3, D)
    if maps.F:
        # fillers: first F systematic (stream 0) bits are known zeros
        d_llr = d_llr.at[:, 0, :maps.F].set(filler_big)
    return d_llr
