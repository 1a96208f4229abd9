"""Tail-biting convolutional code + Viterbi decoder, 3GPP TS 36.212 §5.1.3.1.

Reference parity: openair1/PHY/CODING/ccoding_byte_lte.c (ccodelte_encode,
rate-1/3 K=7 generators {0133, 0171, 0165}) and viterbi_lte.c
(phy_viterbi_lte_sse2 — 64-state add-compare-select with SSE metric tables).

The 64 trellis states live on vector lanes; the ACS recursion is
a `lax.scan` over time with all states updated per step (the reference packs
8 states per __m128i — here all 64 ride one vector, batched over
codewords). Tail-biting is handled circularly: the LLR stream is repeated
and the middle copy's traceback is taken, avoiding any per-state init bias
(the standard wrap-around Viterbi used by hardware decoders).

Encoder I/O is {0,1} bit arrays; decoder input is LLRs with the package-wide
convention positive <=> bit 0 (ops/llr.py).
"""
from __future__ import annotations

import functools

import numpy as np
import jax.numpy as jnp
from jax import lax

# Generator polynomials, MSB = current input bit b_k, LSB = b_{k-6}.
_GENS = (0o133, 0o171, 0o165)
N_STATES = 64


def _parity(x: np.ndarray) -> np.ndarray:
    y = x.copy()
    for s in (4, 2, 1):
        y ^= y >> s
    return y & 1


@functools.lru_cache(maxsize=None)
def _tables():
    """Per (state s = bits b_{k-1}..b_{k-6}, input u): 3 output bits and the
    successor state (u<<5)|(s>>1)."""
    s = np.arange(N_STATES, dtype=np.int64)
    out = np.zeros((2, N_STATES, 3), np.int8)
    nxt = np.zeros((2, N_STATES), np.int32)
    for u in (0, 1):
        reg = (u << 6) | s
        for i, g in enumerate(_GENS):
            out[u, :, i] = _parity(reg & g)
        nxt[u] = (u << 5) | (s >> 1)
    return out, nxt


@functools.lru_cache(maxsize=None)
def _pred_tables():
    """Per state: its two predecessor states and the input bit that was shed.

    s' = (u<<5)|(s>>1) => u = s'>>5, and s ∈ {(s'&31)<<1, ((s'&31)<<1)+1};
    the shed bit b_{k-6} = s&1 is free, the arriving input is u.
    """
    out, nxt = _tables()
    pred = np.zeros((N_STATES, 2), np.int32)    # [s', j] predecessor state
    pred_u = np.zeros((N_STATES,), np.int8)     # input bit consumed entering s'
    pred_out = np.zeros((N_STATES, 2, 3), np.int8)
    for sp in range(N_STATES):
        u = sp >> 5
        base = (sp & 31) << 1
        for j, s in enumerate((base, base + 1)):
            assert nxt[u, s] == sp
            pred[sp, j] = s
            pred_out[sp, j] = out[u, s]
        pred_u[sp] = u
    return pred, pred_u, pred_out


def conv_encode_host(bits: np.ndarray) -> np.ndarray:
    """Tail-biting rate-1/3 encode. bits [K] {0,1} -> [3K] as d0d1d2 streams
    concatenated per 36.212 (d^(i) streams laid out [3, K] then flattened
    stream-major, matching the rate matcher's stream layout)."""
    bits = np.asarray(bits, np.int64)
    K = len(bits)
    out, nxt = _tables()
    # initial state = last 6 input bits, b_{K-1} as most-recent (bit 5)
    s = 0
    for j in range(1, 7):
        s |= int(bits[K - j]) << (6 - j)
    d = np.zeros((3, K), np.int8)
    for k in range(K):
        u = int(bits[k])
        d[:, k] = out[u, s]
        s = int(nxt[u, s])
    return d


def conv_encode_device(bits):
    """Batched tail-biting encode. bits [B, K] -> [B, 3, K] int8."""
    out, nxt = _tables()
    out_t = jnp.asarray(out)   # [2, 64, 3]
    nxt_t = jnp.asarray(nxt)   # [2, 64]
    bits = bits.astype(jnp.int32)
    K = bits.shape[-1]
    w = jnp.asarray([1 << (5 - i) for i in range(6)], jnp.int32)
    s0 = jnp.sum(bits[:, K - 1:K - 7:-1] * w, axis=-1)          # [B]

    def step(s, u):
        return nxt_t[u, s], out_t[u, s]

    _, d = lax.scan(step, s0, jnp.moveaxis(bits, -1, 0))         # [K, B, 3]
    return jnp.transpose(d, (1, 2, 0))                           # [B, 3, K]


def viterbi_decode(llrs, K: int, n_wrap: int = 3):
    """Circular (tail-biting) Viterbi decode.

    llrs: [B, 3, K] float, positive <=> coded bit 0.
    Returns hard decisions [B, K] int8 (info bits).

    The trellis is run over n_wrap copies of the frame; decisions from the
    middle copy are kept, so metrics have converged from any initial state
    (reference decodes the frame twice for the same reason).
    """
    _, _, pred_out = _pred_tables()
    sign = jnp.asarray(1 - 2 * pred_out.astype(np.float32))   # [64,2,3]

    B = llrs.shape[0]
    x = jnp.tile(llrs, (1, 1, n_wrap))                  # [B, 3, n_wrap*K]
    xs = jnp.moveaxis(x, -1, 0).reshape(n_wrap * K, B, 3)

    def acs(metric, l3):
        # metric [B, 64]; l3 [B, 3]. Shift-register trellis: the two
        # predecessors of s' are 2*(s'&31)+j, so the pred-metric tensor
        # is a reshape-to-pairs + tile — no gather inside the scan
        # (round-5 perf: per-step gathers dominated the blind decode).
        bm = jnp.einsum("bc,sjc->bsj", l3, sign,         # [B, 64, 2]
                        precision=lax.Precision.HIGHEST)   # no TF32
        pairs = metric.reshape(B, 32, 2)                 # m[2i], m[2i+1]
        cand = jnp.tile(pairs, (1, 2, 1)) + bm           # [B, 64, 2]
        choice = jnp.argmax(cand, axis=-1)               # [B, 64]
        new = jnp.max(cand, axis=-1)
        new = new - jnp.max(new, axis=-1, keepdims=True)
        return new, choice.astype(jnp.int8)

    m0 = jnp.zeros((B, N_STATES), jnp.float32)
    mfin, choices = lax.scan(acs, m0, xs)                # choices [T, B, 64]

    # Traceback from the best final state through all wraps — all
    # arithmetic on a one-hot state vector (u = s'>>5, prev =
    # 2*(s'&31)+j; the only "lookup" is a 64-wide dot with the one-hot).
    iota64 = jnp.arange(N_STATES, dtype=jnp.int32)

    def back(state, ch):
        # state [B] int32; ch [B, 64] int8
        onehot = (state[:, None] == iota64[None, :])
        j = jnp.sum(jnp.where(onehot, ch.astype(jnp.int32), 0), axis=-1)
        u = (state >> 5).astype(jnp.int8)
        prev = 2 * (state & 31) + j
        return prev, u

    s_best = jnp.argmax(mfin, axis=-1).astype(jnp.int32)
    _, us = lax.scan(back, s_best, choices, reverse=True)   # [T, B]
    bits = jnp.transpose(us, (1, 0))                         # [B, T]
    mid = (n_wrap // 2) * K
    return bits[:, mid:mid + K]
