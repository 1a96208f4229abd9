"""3GPP TS 36.212 §5.1.3.2 turbo codec.

Reference parity (behavior, not code):
  - encoder: openair1/PHY/CODING/3gpplte_sse.c:380 (threegpplte_turbo_encoder)
  - decoder: openair1/PHY/CODING/3gpplte_turbo_decoder_sse.c:1978-2600
    (max-log-MAP with per-iteration CRC early stop)

Architecture (a redesign for batched devices, not a translation):
  * Encoder: the RSC constituent encoders are linear and time-invariant
    over GF(2) with a period-7 impulse response, so both parity streams
    are stride-7 prefix-XORs (turbo_encode_device); only the 3-step
    termination needs a tiny LUT.
  * Decoder: windowed max-log-MAP. The trellis of length K+3 is cut into
    windows of W steps; all windows run their alpha (forward) and beta
    (backward) recursions in lockstep inside one `lax.scan` of length W+U
    (U = warm-up overlap steps seeded from uniform metrics — the standard
    next-iteration-initialization-free sliding window of hardware decoders).
    The 8 trellis states ride the *leading* axis (full-width vectors),
    alpha and beta sweeps share one `lax.scan` with an unrolled body, and
    the QPP (de)interleave is a static gather (_permute) — the sequential
    critical path is (W+U)/R loop iterations instead of K+3 ≈ 6147. On
    the GPU the half-iteration is one Pallas kernel instead
    (ops/turbo_pallas.py); ops/decoder_settings.py picks W, U and the
    route per backend.
  * Per-iteration hard decisions + CRC check (one matmul, ops/crc.py)
    emulate the reference's CRC early stop: the first passing decision is
    latched per batch element (BLER-equivalent to stopping, without dynamic
    control flow under jit).

LLR sign convention everywhere: LLR = log P(bit=0)/P(bit=1) — positive LLR
means bit 0 (matches the constellation mapping where bit 0 selects the
positive axis).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import jax
import jax.numpy as jnp

from ..tables.qpp import QPP_BY_K
from .crc import crc_matrix
from .decoder_settings import DecoderSettings, decoder_settings

# ---------------------------------------------------------------------------
# Trellis: RSC with feedback g0 = 1+D^2+D^3, feedforward g1 = 1+D+D^3.
# State s = r1*4 + r2*2 + r3 (r1 newest). Input u: a = u^r2^r3,
# parity z = a^r1^r3, next state = a*4 + r1*2 + r2.
# ---------------------------------------------------------------------------

def _trellis():
    nxt = np.zeros((8, 2), np.int32)
    par = np.zeros((8, 2), np.int32)
    for s in range(8):
        r1, r2, r3 = (s >> 2) & 1, (s >> 1) & 1, s & 1
        for u in (0, 1):
            a = u ^ r2 ^ r3
            z = a ^ r1 ^ r3
            nxt[s, u] = a * 4 + r1 * 2 + r2
            par[s, u] = z
    return nxt, par


NEXT_STATE, PARITY = _trellis()

# Predecessors: PRED_S[s'] = 2 predecessor states, PRED_U[s'] = input bits.
_pred = [[] for _ in range(8)]
for _s in range(8):
    for _u in (0, 1):
        _pred[NEXT_STATE[_s, _u]].append((_s, _u))
PRED_S = np.array([[p[0][0], p[1][0]] for p in _pred], np.int32)  # [8, 2]
PRED_U = np.array([[p[0][1], p[1][1]] for p in _pred], np.int32)  # [8, 2]
# Parity of the incoming transitions: PARITY[PRED_S[s,j], PRED_U[s,j]]
PRED_Z = PARITY[PRED_S, PRED_U]


def qpp_interleaver(K: int) -> np.ndarray:
    """pi[j] = (f1*j + f2*j^2) mod K: decoder-2 position j reads input pi[j]."""
    f1, f2 = QPP_BY_K[K]
    j = np.arange(K, dtype=np.int64)
    return ((f1 * j + f2 * j * j) % K).astype(np.int32)


# ---------------------------------------------------------------------------
# Host golden encoder (serial, for tests and config-time vectors)
# ---------------------------------------------------------------------------

def _rsc_encode_host(bits: np.ndarray):
    """bits [K] -> (x [K+3], z [K+3], final tail); trellis-terminated."""
    K = len(bits)
    x = np.zeros(K + 3, np.int8)
    z = np.zeros(K + 3, np.int8)
    s = 0
    for k in range(K):
        u = int(bits[k])
        r1, r2, r3 = (s >> 2) & 1, (s >> 1) & 1, s & 1
        a = u ^ r2 ^ r3
        x[k] = u
        z[k] = a ^ r1 ^ r3
        s = a * 4 + r1 * 2 + r2
    for k in range(K, K + 3):  # termination: force a=0 => u = r2^r3
        r1, r2, r3 = (s >> 2) & 1, (s >> 1) & 1, s & 1
        u = r2 ^ r3
        x[k] = u
        z[k] = 0 ^ r1 ^ r3      # a = 0
        s = r1 * 2 + r2         # a*4 = 0
    assert s == 0, "trellis must terminate in state 0"
    return x, z


def turbo_encode_host(bits: np.ndarray) -> np.ndarray:
    """bits [K] {0,1} -> d [3, K+4] streams per 36.212 §5.1.3.2.2.

    Filler handling is the caller's job (fillers are encoded as zeros and the
    rate matcher marks their d0/d1 positions <NULL>).
    """
    K = len(bits)
    pi = qpp_interleaver(K)
    x1, z1 = _rsc_encode_host(bits)
    x2, z2 = _rsc_encode_host(np.asarray(bits)[pi])
    d = np.zeros((3, K + 4), np.int8)
    d[0, :K] = x1[:K]
    d[1, :K] = z1[:K]
    d[2, :K] = z2[:K]
    # Tail interlacing per 36.212 (d_K..d_{K+3} columns):
    d[0, K:] = [x1[K], z1[K + 1], x2[K], z2[K + 1]]
    d[1, K:] = [z1[K], x1[K + 2], z2[K], x2[K + 2]]
    d[2, K:] = [x1[K + 1], z1[K + 2], x2[K + 1], z2[K + 2]]
    return d


# ---------------------------------------------------------------------------
# Device encoder: stride-7 prefix-XOR (the RSC is an LFSR with primitive
# feedback 1+D^2+D^3, so its impulse response is PERIODIC with period 2^3-1=7
# after t=0: h = [1; (1,1,1,0,0,1,0) repeating]. The GF(2) Toeplitz matmul
# therefore collapses to four shifted copies of a period-7 prefix-XOR —
# O(K) work per block via one reshape + cumsum, with no [K, 2K] generator
# constant (which at K=6144 was a 151 MB literal per compiled program).
# ---------------------------------------------------------------------------

# h[d] = 1 for d >= 1 iff d mod 7 in {1,2,3,6}; h[0] = 1.
_H_SHIFTS = (1, 2, 3, 6)
# state-bit impulse responses (periodic from d=1, no transient):
# bit b of state-after-d-steps is 1 iff d mod 7 in _STATE_RES[b]
_STATE_RES = {4: (1, 3, 4, 5), 2: (2, 4, 5, 6), 1: (0, 3, 5, 6)}


def _rsc_encode_scan(bits):
    """bits [B, K] int32 {0,1} -> (z [B, K] parity, s [B] final state).

    P[k] = XOR of bits[k], bits[k-7], bits[k-14], ... (stride-7 prefix sums,
    computed as a [B, M, 7] cumsum); then
      z[t] = u[t] ^ P[t-1] ^ P[t-2] ^ P[t-3] ^ P[t-6]
    and the final state bits are parity-selected residue-class totals T[c].
    """
    B, K = bits.shape
    M = -(-K // 7)
    pad = jnp.zeros((B, M * 7 - K), bits.dtype)
    u = jnp.concatenate([bits, pad], axis=1)
    Pc = jnp.cumsum(u.reshape(B, M, 7), axis=1)        # [B, M, 7]
    P = jnp.mod(Pc.reshape(B, M * 7)[:, :K], 2)
    z = bits
    zero = jnp.zeros((B, 1), P.dtype)
    for r in _H_SHIFTS:
        shifted = jnp.concatenate(
            [jnp.broadcast_to(zero, (B, r)), P[:, :K - r]], axis=1)
        z = z + shifted
    z = jnp.mod(z, 2)
    # residue-class totals: T[c] = XOR of bits over indices == c (mod 7)
    Pm = jnp.mod(Pc[:, M - 1, :], 2)                   # [B, 7]
    s = jnp.zeros((B,), jnp.int32)
    for val, residues in _STATE_RES.items():
        sel = np.zeros(7, np.int32)
        for c in range(7):
            if (K - c) % 7 in residues:
                sel[c] = 1
        bit = jnp.mod(jnp.sum(Pm * jnp.asarray(sel)[None, :], axis=1), 2)
        s = s + val * bit.astype(jnp.int32)
    return z.astype(jnp.int32), s


@functools.lru_cache(maxsize=None)
def _tail_tables():
    """Per final state: tail input bits x[3] and parities z[3] (termination)."""
    tx = np.zeros((8, 3), np.int32)
    tz = np.zeros((8, 3), np.int32)
    for s0 in range(8):
        s = s0
        for t in range(3):
            r1, r2, r3 = (s >> 2) & 1, (s >> 1) & 1, s & 1
            tx[s0, t] = r2 ^ r3
            tz[s0, t] = r1 ^ r3
            s = r1 * 2 + r2
    return tx, tz


def _tails(bits_or_state):
    tx, tz = _tail_tables()
    return jnp.asarray(tx)[bits_or_state], jnp.asarray(tz)[bits_or_state]


def turbo_encode_device(bits, pi: np.ndarray):
    """bits [B, K] int32 -> d [B, 3, K+4]. `pi` = qpp_interleaver(K) (static).

    The RSC constituent encoders are LTI over GF(2) with a
    period-7 impulse response, so both parity streams are stride-7
    prefix-XORs (one cumsum each, `_rsc_encode_scan`) — O(K) work and no
    large generator constants; only the 3-step trellis termination needs
    the tiny tail LUTs.
    """
    B, K = bits.shape
    pi = jnp.asarray(pi)
    bits2 = bits[:, pi]
    z1f, s1 = _rsc_encode_scan(bits)
    z2f, s2 = _rsc_encode_scan(bits2)
    tx1, tz1 = _tails(s1)
    tx2, tz2 = _tails(s2)
    x1 = jnp.concatenate([bits, tx1], axis=1)
    z1 = jnp.concatenate([z1f, tz1], axis=1)
    x2 = jnp.concatenate([bits2, tx2], axis=1)
    z2 = jnp.concatenate([z2f, tz2], axis=1)
    d0 = jnp.concatenate([x1[:, :K], x1[:, K:K+1], z1[:, K+1:K+2],
                          x2[:, K:K+1], z2[:, K+1:K+2]], axis=1)
    d1 = jnp.concatenate([z1[:, :K], z1[:, K:K+1], x1[:, K+2:K+3],
                          z2[:, K:K+1], x2[:, K+2:K+3]], axis=1)
    d2 = jnp.concatenate([z2[:, :K], x1[:, K+1:K+2], z1[:, K+2:K+3],
                          x2[:, K+1:K+2], z2[:, K+2:K+3]], axis=1)
    return jnp.stack([d0, d1, d2], axis=1)


# ---------------------------------------------------------------------------
# Windowed max-log-MAP decoder
# ---------------------------------------------------------------------------

NEG = -1e9   # "minus infinity" metric
BIG = 1e4    # LLR magnitude for known bits (fillers / pad region)




def _frame_fwd(g, W: int, U: int):
    """[B, N] -> [B, n_w, W+U]: window w = positions w*W - U + t (t < W+U),
    front-padded with 0. Pure reshape/slice/concat — no gather."""
    B, N = g.shape
    n_w = N // W
    padded = jnp.concatenate([jnp.zeros((B, U), g.dtype), g], axis=1)
    warm = padded[:, :n_w * W].reshape(B, n_w, W)[:, :, :U]
    main = g.reshape(B, n_w, W)
    return jnp.concatenate([warm, main], axis=2)


def _frame_bwd(g, W: int, U: int, pad_val: float):
    """[B, N] -> [B, n_w, W+U]: window w = positions w*W + t, end-padded."""
    B, N = g.shape
    n_w = N // W
    # pad a full W so the strided tail view exists for the last window
    padded = jnp.concatenate(
        [g, jnp.full((B, W), pad_val, g.dtype)], axis=1)
    main = g.reshape(B, n_w, W)
    tail = padded[:, W:].reshape(B, n_w, W)[:, :, :U]
    return jnp.concatenate([main, tail], axis=2)


def _permute(x, K: int, inverse: bool):
    """QPP (de)interleave as a static gather: y[:, j] = x[:, pi[j]], or
    its inverse."""
    pi = qpp_interleaver(K)
    if inverse:
        idx = np.empty(K, np.int32)
        idx[pi] = np.arange(K, dtype=np.int32)
    else:
        idx = pi
    return x[:, jnp.asarray(idx)]


def _alpha_step(alpha, gu, gp):
    """One forward trellis step, STATE-MAJOR: alpha [8, ...]; gu/gp [...].

    The 8-state axis is the *leading* axis (a minor axis of 8 would leave
    most of each vector idle); all trellis wiring is static Python
    indexing, so XLA sees only full-width elementwise ops — the batched
    analog of the reference keeping 8 states in one __m128i
    (3gpplte_turbo_decoder_sse.c:399).
    gamma(s,u) = (1-2u)*gu + (1-2*PARITY[s,u])*gp.
    """
    new = []
    for s in range(8):
        c = []
        for j in (0, 1):
            p = int(PRED_S[s, j])
            su = 1.0 - 2.0 * float(PRED_U[s, j])
            sz = 1.0 - 2.0 * float(PRED_Z[s, j])
            c.append(alpha[p] + su * gu + sz * gp)
        new.append(jnp.maximum(c[0], c[1]))
    m = new[0]
    for s in range(1, 8):
        m = jnp.maximum(m, new[s])
    return jnp.stack([x - m for x in new])


def _beta_step(beta, gu, gp):
    """One backward step (state-major): beta_k[s] = max_u beta_{k+1}[NEXT[s,u]]
    + gamma(s,u)."""
    new = []
    for s in range(8):
        c = []
        for u in (0, 1):
            nx = int(NEXT_STATE[s, u])
            su = 1.0 - 2.0 * u
            sz = 1.0 - 2.0 * float(PARITY[s, u])
            c.append(beta[nx] + su * gu + sz * gp)
        new.append(jnp.maximum(c[0], c[1]))
    m = new[0]
    for s in range(1, 8):
        m = jnp.maximum(m, new[s])
    return jnp.stack([x - m for x in new])


def _half_iteration(lin, lp, W: int, U: int, unroll: int | None = None):
    """Max-log BCJR over one constituent code.

    lin, lp: [B, N] combined systematic(+apriori) and parity LLRs, where N is
    already padded to a multiple of W with +BIG entries (forced state-0 region
    after the tail). Returns llr [B, N] (APP log-ratio for bit=0 vs bit=1).

    Critical-path layout: the alpha (forward) and beta (backward) window
    sweeps are independent, so they ride ONE `lax.scan` together, and the
    scan body unrolls R trellis steps per iteration — (W+U)/R sequential
    loop iterations per half-iteration instead of 2*(W+U). (The reference's
    SIMD decoder has the same alpha/beta structure but is serial in k;
    here windows*batch*states fill the vector lanes.)
    """
    B, N = lin.shape
    n_w = N // W
    T = W + U
    r_max = decoder_settings().unroll if unroll is None else unroll
    R = 1
    for r in (8, 4, 2):
        if r <= r_max and T % r == 0:
            R = r
            break
    gu = 0.5 * lin
    gp = 0.5 * lp

    # ---- forward inputs: window w consumes padded positions w*W + t ----------
    gu_w = jnp.moveaxis(_frame_fwd(gu, W, U), -1, 0)            # [T, B, n_w]
    gp_w = jnp.moveaxis(_frame_fwd(gp, W, U), -1, 0)

    # ---- backward inputs at reversed t order ---------------------------------
    # beyond N: forced state-0 region (+BIG known bits)
    gu_wb = jnp.moveaxis(_frame_bwd(gu, W, U, BIG), -1, 0)[::-1]
    gp_wb = jnp.moveaxis(_frame_bwd(gp, W, U, BIG), -1, 0)[::-1]

    exact0 = jnp.asarray(np.concatenate([[0.0], np.full(7, NEG)])
                         )[:, None, None]           # [8, 1, 1] state-major
    # start-override mask per t: at t == U window 0 is the true trellis start
    start_mask = np.zeros(T, bool)
    start_mask[U] = True
    win0 = jnp.asarray(np.arange(n_w) == 0)[None, None, :]   # [1, 1, n_w]

    def rsh(x):
        return x.reshape(T // R, R, *x.shape[1:])

    def body(carry, xs):
        alpha, beta = carry                        # [8, B, n_w] each
        sm, guf, gpf, gub, gpb = xs
        alphas, betas = [], []
        for r in range(R):
            a = jnp.where(sm[r] & win0, exact0, alpha)
            alphas.append(a)
            alpha = _alpha_step(a, guf[r], gpf[r])
            beta = _beta_step(beta, gub[r], gpb[r])
            betas.append(beta)
        return (alpha, beta), (jnp.stack(alphas), jnp.stack(betas))

    init = (jnp.zeros((8, B, n_w)), jnp.zeros((8, B, n_w)))
    _, (alphas, betas) = jax.lax.scan(
        body, init,
        (jnp.asarray(rsh(start_mask)), rsh(gu_w), rsh(gp_w),
         rsh(gu_wb), rsh(gp_wb)))
    alphas = alphas.reshape(T, 8, B, n_w)    # alpha BEFORE step: node t
    betas = betas.reshape(T, 8, B, n_w)      # beta AT node ts_b[i]
    # node index = w*W + (t-U): [8, B, N]
    alpha = jnp.moveaxis(alphas[U:], 0, 3).reshape(8, B, N)
    betas = betas[::-1]                      # now indexed by t: beta at node t
    beta = jnp.moveaxis(betas[:W], 0, 3).reshape(8, B, N)

    # beta_next[k] = beta at node k+1: shift left, terminal node = state 0
    term = jnp.broadcast_to(exact0, (8, B, 1))
    beta_next = jnp.concatenate([beta[:, :, 1:], term], axis=2)

    # ---- LLR: max over u=0 transitions minus max over u=1 --------------------
    llr01 = []
    for u in (0, 1):
        m = None
        for s in range(8):
            sz = 1.0 - 2.0 * float(PARITY[s, u])
            c = alpha[s] + sz * gp + beta_next[int(NEXT_STATE[s, u])]
            m = c if m is None else jnp.maximum(m, c)
        llr01.append(m)
    # gamma's systematic part: +gu for u=0, -gu for u=1
    return (llr01[0] + gu) - (llr01[1] - gu)


def _half_iteration_dispatch(lin, prep, W: int, U: int):
    """`prep` comes from _parity_prep: ("triton", framed parity) runs the
    Pallas kernel of ops/turbo_pallas.py, ("xla", lp) the scan above."""
    if prep[0] == "triton":
        from .turbo_pallas import half_iteration
        return half_iteration(lin, prep[1], W, U, prep[2])
    return _half_iteration(lin, prep[1], W, U, prep[2])


def _parity_prep(lp, W: int, U: int, settings: DecoderSettings):
    """The parity streams are the same in every turbo iteration, so the
    kernel's framing of them runs once, before the iteration loop."""
    if settings.half_iter == "triton":
        from .turbo_pallas import prep_parity
        return ("triton", prep_parity(lp, W, U, settings.lanes),
                settings.lanes)
    if settings.half_iter == "xla":
        return ("xla", lp, settings.unroll)
    raise ValueError(f"unknown half-iteration route {settings.half_iter!r}")


@dataclass(frozen=True)
class TurboDecoderConfig:
    K: int                 # code block size (bits, incl. any CRC)
    F: int = 0             # filler bits at block head (known zeros)
    n_iter: int = 8        # full iterations (reference default max 8)
    window: int | None = None   # W: trellis window length
    warmup: int | None = None   # U: window warm-up overlap
    #   (None: the backend's entry in ops/decoder_settings.py)
    crc_kind: str = "crc24a"   # CRC embedded at block tail for early-stop latch
    dynamic_stop: bool = True  # exit the iteration loop once EVERY block
    #   in the batch latched a passing CRC (lax.while_loop) — the
    #   reference's early-return semantics (…decoder_sse.c:2590) at
    #   batch granularity. Output-identical to the fixed scan (the latch
    #   freezes each block's bits at its own first pass); at operating
    #   SNRs this cuts decode time by the mean-iteration ratio.


def _padded_len(KT: int, W: int) -> int:
    return -(-KT // W) * W


def turbo_decode(llr_d, cfg: TurboDecoderConfig):
    """Batched turbo decode.

    llr_d: [B, 3, K+4] LLRs for the d0/d1/d2 streams (rate-matching already
    reversed; fillers may carry +BIG). Returns (bits [B, K] int32,
    crc_ok [B] bool). Decisions are latched at the first iteration whose CRC
    passes (reference early-stop semantics, 3gpplte_turbo_decoder_sse.c:2590).
    """
    K = cfg.K
    settings = decoder_settings()
    W = settings.window if cfg.window is None else cfg.window
    U = settings.warmup if cfg.warmup is None else cfg.warmup
    KT = K + 3
    N = _padded_len(KT, W)
    B = llr_d.shape[0]

    d0, d1, d2 = llr_d[:, 0], llr_d[:, 1], llr_d[:, 2]
    # De-interlace tails (36.212 tail mapping, see turbo_encode_host):
    sys1 = jnp.concatenate([d0[:, :K], d0[:, K:K+1], d2[:, K:K+1],
                            d1[:, K+1:K+2]], axis=1)                 # x_K..x_K+2
    par1 = jnp.concatenate([d1[:, :K], d1[:, K:K+1], d0[:, K+1:K+2],
                            d2[:, K+1:K+2]], axis=1)                 # z_K..z_K+2
    sys2_tail = jnp.concatenate([d0[:, K+2:K+3], d2[:, K+2:K+3],
                                 d1[:, K+3:K+4]], axis=1)            # x'_K..x'_K+2
    par2 = jnp.concatenate([d2[:, :K], d1[:, K+2:K+3], d0[:, K+3:K+4],
                            d2[:, K+3:K+4]], axis=1)                 # z'_K..z'_K+2

    sys_ch = sys1[:, :K]    # channel LLR for systematic bits (original order)

    pad = jnp.full((B, N - KT), BIG)
    par1_p = jnp.concatenate([par1, pad], axis=1)
    par2_p = jnp.concatenate([par2, pad], axis=1)
    tail1 = sys1[:, K:]
    # parity framing is iteration-invariant: hoist it out of the scan
    prep1 = _parity_prep(par1_p, W, U, settings)
    prep2 = _parity_prep(par2_p, W, U, settings)

    # CRC check matrix covers the non-filler payload (data||crc).
    crc_ok_fn = _make_crc_checker(K - cfg.F, cfg.crc_kind)

    def one_iteration(carry, _):
        la1, done, bits_latched = carry
        # --- decoder 1 ---
        lin1 = jnp.concatenate([sys_ch + la1, tail1, pad], axis=1)
        llr1 = _half_iteration_dispatch(lin1, prep1, W, U)
        ext1 = llr1[:, :K] - lin1[:, :K]
        # --- decoder 2 --- (QPP (de)interleave = gather)
        apri2 = _permute(sys_ch + ext1, K, inverse=False)
        lin2 = jnp.concatenate([apri2, sys2_tail, pad], axis=1)
        llr2 = _half_iteration_dispatch(lin2, prep2, W, U)
        ext2 = llr2[:, :K] - lin2[:, :K]
        la1_new = _permute(ext2, K, inverse=True)
        # --- decision + CRC latch ---
        # Decoder 2's APP deinterleaved: lin2 + ext2 = (sys_ch + ext1) + ext2.
        llr_final = sys_ch + ext1 + la1_new
        bits = (llr_final < 0).astype(jnp.int32)   # LLR>0 => bit 0
        ok = crc_ok_fn(bits)
        newly = ok & ~done
        bits_latched = jnp.where(newly[:, None], bits, bits_latched)
        done = done | ok
        return (la1_new, done, bits_latched), None

    init = (jnp.zeros((B, K)), jnp.zeros(B, bool), jnp.zeros((B, K), jnp.int32))
    if cfg.dynamic_stop:
        def cond(state):
            it, la1, done, lat = state
            return (it < cfg.n_iter) & ~jnp.all(done)

        def body(state):
            it, la1, done, lat = state
            (la1, done, lat), _ = one_iteration((la1, done, lat), None)
            return (it + 1, la1, done, lat)

        _, la1, done, bits_latched = jax.lax.while_loop(
            cond, body, (jnp.int32(0),) + init)
        return bits_latched, done
    (la1, done, bits_latched), _ = jax.lax.scan(
        one_iteration, init, None, length=cfg.n_iter)
    return bits_latched, done


def _make_crc_checker(n_payload: int, kind: str):
    H = jnp.asarray(crc_matrix(n_payload, kind), jnp.float32)

    def check(bits):
        # bits [B, K]; payload = last n_payload positions (fillers at head)
        payload = bits[:, bits.shape[1] - n_payload:].astype(jnp.float32)
        # 0/1 operands with float32 accumulation: exact in TF32 as well
        rem = jnp.mod(jnp.matmul(payload, H, preferred_element_type=jnp.float32), 2.0)
        return jnp.all(rem < 0.5, axis=-1)

    return check
