"""Real 3GPP security algorithms: SNOW3G (128-EEA1/128-EIA1) and AES
(128-EEA2/128-EIA2), per TS 33.401 Annex B with the UEA2/UIA2 SNOW3G core
(ETSI/SAGE specification, TS 35.215/35.216).

Reference parity (behavior, not code): openair-cn/SECU/{snow3g.c,
nas_stream_eea1.c, nas_stream_eia1.c, nas_stream_eea2.c,
nas_stream_eia2.c} — validated against the same published test vectors
the reference ships (33.401 Annex C; UEA2/UIA2 Implementors' Test Data),
see tests/test_crypto_33401.py.

Host-side scalar code by design: NAS/RRC integrity and ciphering touch a
few hundred bytes per procedure — nothing here for the device. The
SNOW3G S-boxes are *generated* from their algebraic definitions (AES
S-box construction for S_R; Dickson polynomial g49 over
GF(2^8)/x^8+x^6+x^5+x^3+1 xor 0x25 for S_Q) rather than transcribed.
"""
from __future__ import annotations

import functools

# AES primitives (CTR, CMAC, ECB) from the baked-in `cryptography` wheel.
from cryptography.hazmat.primitives.ciphers import Cipher, algorithms, modes
from cryptography.hazmat.primitives import cmac

MASK32 = 0xFFFFFFFF


# ------------------------------------------------------------ GF(2^8) --

def _gmul(a: int, b: int, mod: int) -> int:
    r = 0
    while b:
        if b & 1:
            r ^= a
        b >>= 1
        a <<= 1
        if (a >> 8) & 1:
            a ^= mod
    return r


def _gpow(a: int, n: int, mod: int) -> int:
    r = 1
    while n:
        if n & 1:
            r = _gmul(r, a, mod)
        a = _gmul(a, a, mod)
        n >>= 1
    return r


def _gen_sr() -> list[int]:
    """AES S-box: inverse in GF(2^8)/0x11b + affine transform."""
    out = []
    for x in range(256):
        y = 0 if x == 0 else _gpow(x, 254, 0x11B)
        s = y
        for _ in range(4):
            y = ((y << 1) | (y >> 7)) & 0xFF
            s ^= y
        out.append(s ^ 0x63)
    return out


def _gen_sq() -> list[int]:
    """SNOW3G S_Q: Dickson polynomial g49(x) = sum x^e over
    e in {1,9,13,15,33,41,45,47,49} in GF(2^8)/0x169, xor 0x25."""
    out = []
    for x in range(256):
        v = 0
        for e in (1, 9, 13, 15, 33, 41, 45, 47, 49):
            v ^= _gpow(x, e, 0x169)
        out.append(v ^ 0x25)
    return out


_SR = _gen_sr()
_SQ = _gen_sq()


def _mulx(v: int, c: int) -> int:
    return ((v << 1) ^ c) & 0xFF if v & 0x80 else (v << 1) & 0xFF


def _mulxpow(v: int, i: int, c: int) -> int:
    for _ in range(i):
        v = _mulx(v, c)
    return v


@functools.lru_cache(maxsize=None)
def _mulalpha_tab() -> tuple:
    return tuple((_mulxpow(c, 23, 0xA9) << 24) | (_mulxpow(c, 245, 0xA9) << 16)
                 | (_mulxpow(c, 48, 0xA9) << 8) | _mulxpow(c, 239, 0xA9)
                 for c in range(256))


@functools.lru_cache(maxsize=None)
def _divalpha_tab() -> tuple:
    return tuple((_mulxpow(c, 16, 0xA9) << 24) | (_mulxpow(c, 39, 0xA9) << 16)
                 | (_mulxpow(c, 6, 0xA9) << 8) | _mulxpow(c, 64, 0xA9)
                 for c in range(256))


def _sbox32(w: int, box: list[int], c: int) -> int:
    """The 32->32 MixColumn-style S-box of SNOW3G (S1 with S_R/c=0x1b,
    S2 with S_Q/c=0x69)."""
    b0, b1, b2, b3 = (box[(w >> 24) & 0xFF], box[(w >> 16) & 0xFF],
                      box[(w >> 8) & 0xFF], box[w & 0xFF])
    r0 = _mulx(b0, c) ^ b1 ^ b2 ^ _mulx(b3, c) ^ b3
    r1 = _mulx(b0, c) ^ b0 ^ _mulx(b1, c) ^ b2 ^ b3
    r2 = b0 ^ _mulx(b1, c) ^ b1 ^ _mulx(b2, c) ^ b3
    r3 = b0 ^ b1 ^ _mulx(b2, c) ^ b2 ^ _mulx(b3, c)
    return (r0 << 24) | (r1 << 16) | (r2 << 8) | r3


# ------------------------------------------------------------- SNOW3G --

class _Snow3G:
    """SNOW3G keystream generator (35.216 §3/§4): 16-word LFSR over
    GF(2^32) with alpha feedback + 3-register FSM."""

    def __init__(self, k: tuple, iv: tuple):
        ones = MASK32
        k0, k1, k2, k3 = k
        self.s = [k0 ^ ones, k1 ^ ones, k2 ^ ones, k3 ^ ones,
                  k0, k1, k2, k3,
                  k0 ^ ones, k1 ^ ones ^ iv[3], k2 ^ ones ^ iv[2],
                  k3 ^ ones,
                  k0 ^ iv[1], k1, k2, k3 ^ iv[0]]
        self.r1 = self.r2 = self.r3 = 0
        mula, diva = _mulalpha_tab(), _divalpha_tab()
        for _ in range(32):
            f = self._clock_fsm()
            self._clock_lfsr(mula, diva, f)
        self._mula, self._diva = mula, diva

    def _clock_fsm(self) -> int:
        f = ((self.s[15] + self.r1) & MASK32) ^ self.r2
        r = (self.r2 + (self.r3 ^ self.s[5])) & MASK32
        self.r3 = _sbox32(self.r2, _SQ, 0x69)
        self.r2 = _sbox32(self.r1, _SR, 0x1B)
        self.r1 = r
        return f

    def _clock_lfsr(self, mula, diva, f: int = 0) -> None:
        s = self.s
        v = (((s[0] << 8) & 0xFFFFFF00) ^ mula[(s[0] >> 24) & 0xFF]
             ^ s[2] ^ ((s[11] >> 8) & 0x00FFFFFF) ^ diva[s[11] & 0xFF] ^ f)
        s.pop(0)
        s.append(v)

    def keystream(self, n: int) -> list[int]:
        """n 32-bit keystream words z_1..z_n (35.216 §4.2)."""
        self._clock_fsm()                      # discard
        self._clock_lfsr(self._mula, self._diva)
        out = []
        for _ in range(n):
            f = self._clock_fsm()
            out.append(f ^ self.s[0])
            self._clock_lfsr(self._mula, self._diva)
        return out


def _snow3g_words(key: bytes, iv_words: tuple, n: int) -> list[int]:
    """Run SNOW3G with the 33.401 key layout: K3 = key[0:4] (MSBs) ...
    K0 = key[12:16]."""
    k = (int.from_bytes(key[12:16], "big"), int.from_bytes(key[8:12], "big"),
         int.from_bytes(key[4:8], "big"), int.from_bytes(key[0:4], "big"))
    # _Snow3G takes iv as (IV0, IV1, IV2, IV3)
    return _Snow3G(k, iv_words).keystream(n)


def _mask_tail(data: bytearray, bitlen: int, out_len: int) -> bytes:
    """Zero everything after `bitlen` bits and return `out_len` bytes
    (non-byte-aligned messages keep their padded length, tail zeroed —
    the convention of the 33.401 Annex C vectors)."""
    nbytes = (bitlen + 7) // 8
    for i in range(nbytes, len(data)):
        data[i] = 0
    rem = bitlen & 7
    if rem:
        data[nbytes - 1] &= (0xFF << (8 - rem)) & 0xFF
    del data[out_len:]
    data.extend(b"\0" * (out_len - len(data)))
    return bytes(data)


# -------------------------------------------------------- 128-EEA1/EIA1 --

def eea1(key: bytes, count: int, bearer: int, direction: int,
         data: bytes, bitlen: int | None = None) -> bytes:
    """SNOW3G ciphering (33.401 Annex B.1.2): IV from
    (COUNT, BEARER||DIR||0..); keystream XOR."""
    if bitlen is None:
        bitlen = 8 * len(data)
    n = (bitlen + 31) // 32
    iv2 = (((bearer & 0x1F) << 3) | ((direction & 1) << 2)) << 24
    ks = _snow3g_words(key, (iv2, count & MASK32, iv2, count & MASK32), n)
    stream = b"".join(w.to_bytes(4, "big") for w in ks)
    out = bytearray(x ^ s for x, s in zip(data.ljust(4 * n, b"\0"), stream))
    return _mask_tail(out, bitlen, len(data))


def _mul64(v: int, p: int) -> int:
    """V * P in GF(2^64) modulo x^64+x^4+x^3+x+1 (c = 0x1b)."""
    r = 0
    for _ in range(64):
        if p & 1:
            r ^= v
        p >>= 1
        v <<= 1
        if v >> 64:
            v = (v & 0xFFFFFFFFFFFFFFFF) ^ 0x1B
    return r


def eia1(key: bytes, count: int, bearer: int, direction: int,
         msg: bytes, bitlen: int | None = None) -> bytes:
    """SNOW3G 32-bit MAC (33.401 Annex B.2.2 / UIA2 structure):
    polynomial evaluation of the message over GF(2^64) at P, times Q,
    xor OTP — P,Q,OTP from 5 keystream words."""
    if bitlen is None:
        bitlen = 8 * len(msg)
    fresh = (bearer & 0x1F) << 27
    iv = (fresh ^ ((direction & 1) << 15),
          (count ^ ((direction & 1) << 31)) & MASK32,
          fresh, count & MASK32)
    z = _snow3g_words(key, iv, 5)
    p = (z[0] << 32) | z[1]
    q = (z[2] << 32) | z[3]
    d = (bitlen + 63) // 64 + 1     # ceil(bitlen/64) + 1, last = LENGTH
    m = msg.ljust(8 * (d - 1), b"\0")
    ev = 0
    for i in range(d - 2):
        ev = _mul64(ev ^ int.from_bytes(m[8 * i:8 * i + 8], "big"), p)
    # D-2 block: mask to bitlen (full last block when aligned)
    rem = bitlen % 64 or 64
    last = int.from_bytes(m[8 * (d - 2):8 * (d - 1)], "big")
    last &= ((1 << rem) - 1) << (64 - rem)
    ev = _mul64(ev ^ last, p)
    ev = _mul64(ev ^ bitlen, q)
    return ((ev >> 32) ^ z[4]).to_bytes(4, "big")


# -------------------------------------------------------- 128-EEA2/EIA2 --

def eea2(key: bytes, count: int, bearer: int, direction: int,
         data: bytes, bitlen: int | None = None) -> bytes:
    """AES-128-CTR (33.401 Annex B.1.3): T1 = COUNT||BEARER||DIR||0^26
    || 0^64 as the initial counter block."""
    if bitlen is None:
        bitlen = 8 * len(data)
    nonce = (count & MASK32).to_bytes(4, "big") \
        + bytes([((bearer & 0x1F) << 3) | ((direction & 1) << 2)]) \
        + b"\0" * 11
    enc = Cipher(algorithms.AES(key), modes.CTR(nonce)).encryptor()
    nbytes = (bitlen + 7) // 8
    out = bytearray(enc.update(data[:nbytes].ljust(nbytes, b"\0")))
    return _mask_tail(out, bitlen, len(data))


def eia2(key: bytes, count: int, bearer: int, direction: int,
         msg: bytes, bitlen: int | None = None) -> bytes:
    """AES-128-CMAC (33.401 Annex B.2.3): MAC over COUNT||BEARER||DIR||
    0^26||MESSAGE, truncated to 32 MSBs. Byte-aligned messages only
    (EPS NAS/RRC PDUs are byte-aligned)."""
    if bitlen is not None:
        assert bitlen % 8 == 0, "EIA2 here supports byte-aligned input"
        msg = msg[:bitlen // 8]
    block = (count & MASK32).to_bytes(4, "big") \
        + bytes([((bearer & 0x1F) << 3) | ((direction & 1) << 2)]) \
        + b"\0" * 3 + msg
    c = cmac.CMAC(algorithms.AES(key))
    c.update(block)
    return c.finalize()[:4]


# ------------------------------------------------------------ dispatch --

def eea_apply(alg: int, key: bytes, count: int, bearer: int,
              direction: int, data: bytes) -> bytes:
    """Cipher/decipher (stream ciphers are involutions) by EEA id."""
    if alg == 0:
        return data                                   # EEA0 null
    if alg == 1:
        return eea1(key, count, bearer, direction, data)
    if alg == 2:
        return eea2(key, count, bearer, direction, data)
    raise ValueError(f"unknown EEA{alg}")


def eia_compute(alg: int, key: bytes, count: int, bearer: int,
                direction: int, msg: bytes) -> bytes:
    """32-bit MAC by EIA id (EIA0 is not a valid LTE choice outside
    emergency attach; it returns zeros here for completeness)."""
    if alg == 0:
        return b"\0\0\0\0"
    if alg == 1:
        return eia1(key, count, bearer, direction, msg)
    if alg == 2:
        return eia2(key, count, bearer, direction, msg)
    raise ValueError(f"unknown EIA{alg}")
