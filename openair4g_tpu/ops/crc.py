"""CRC attachment/checking per 3GPP TS 36.212 §5.1.1.

Reference parity: openair1/PHY/CODING/crc_byte.c (polys :53-57, byte-LUT
crc24a/crc24b/crc16/crc8). The reference computes CRCs serially with byte
lookup tables; here the CRC of a K-bit message is a GF(2)
matrix-vector product — remainder_bits = (bits @ H) mod 2 with a precomputed
[K, L] matrix H — which batches over thousands of code blocks as one
matmul. This is the per-iteration early-stop check inside the turbo decoder,
so it must be cheap and batched.

Bit convention: bits are given MSB-first (bit 0 of the message is the highest
degree term), matching the reference's "first bit is in the MSB of each byte"
(crc_byte.c:62) and 36.212 a_0..a_{A-1} ordering.
"""
from __future__ import annotations

import functools

import numpy as np
import jax.numpy as jnp

# Polynomial bit vectors, MSB (x^L) first, per 36.212 §5.1.1 / crc_byte.c:53-57.
CRC_POLYS = {
    "crc24a": (24, 0x1864CFB),
    "crc24b": (24, 0x1800063),
    "crc16": (16, 0x11021),
    "crc12": (12, 0x180F),
    "crc8": (8, 0x19B),
}


def crc_bits_host(bits: np.ndarray, kind: str) -> np.ndarray:
    """Serial golden CRC: bits [K] in {0,1} MSB-first -> remainder [L]."""
    L, poly = CRC_POLYS[kind]
    reg = 0
    for b in np.asarray(bits, np.int64):
        reg = (reg << 1) | int(b)
        if reg >> L:
            reg ^= poly
    # flush L zero bits
    for _ in range(L):
        reg <<= 1
        if reg >> L:
            reg ^= poly
    return np.array([(reg >> (L - 1 - i)) & 1 for i in range(L)], np.int8)


@functools.lru_cache(maxsize=None)
def crc_matrix(K: int, kind: str) -> np.ndarray:
    """[K, L] GF(2) matrix H s.t. crc(bits) = (bits @ H) mod 2.

    Column construction: H[i] = remainder of x^(K-1-i) * x^L mod g(x), i.e. the
    CRC of a message with only bit i set. Built in O(K) by stepping a single
    LFSR register backwards-to-forwards.
    """
    L, poly = CRC_POLYS[kind]
    H = np.zeros((K, L), np.int8)
    r = 1
    for _ in range(L):
        r <<= 1
        if r >> L:
            r ^= poly
    # r = x^L mod g. Now walk i from last bit (K-1) to first: multiply by x.
    for i in range(K - 1, -1, -1):
        H[i] = [(r >> (L - 1 - j)) & 1 for j in range(L)]
        r <<= 1
        if r >> L:
            r ^= poly
    return H


def attach_crc_host(bits: np.ndarray, kind: str) -> np.ndarray:
    return np.concatenate([np.asarray(bits, np.int8), crc_bits_host(bits, kind)])


def crc_device(bits, kind: str):
    """Batched device CRC. bits [..., K] float32/int in {0,1} -> [..., L].

    One f32 matmul + mod-2; exact for K < 2^24.
    """
    K = bits.shape[-1]
    H = jnp.asarray(crc_matrix(K, kind), jnp.float32)
    # default precision on purpose: the operands are 0/1, which TF32
    # holds exactly, and the sums accumulate in float32
    s = jnp.matmul(bits.astype(jnp.float32), H, preferred_element_type=jnp.float32)
    return jnp.mod(s, 2.0)


def crc_ok_device(bits_with_crc, kind: str):
    """[..., K+L] message||crc -> bool [...]: True iff CRC checks.

    Uses the standard property that the CRC of message||crc is zero.
    """
    rem = crc_device(bits_with_crc, kind)
    return jnp.all(rem < 0.5, axis=-1)
