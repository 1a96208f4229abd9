"""PBCH: MIB encode/decode with blind antenna + frame-phase detection.

Reference parity: openair1/PHY/LTE_TRANSPORT/pbch.c (generate_pbch :162 —
CRC16 masked by the antenna-count mask, tail-biting CC encode, rate match to
1920, QPSK, 4-frame spread; rx_pbch :876 — Viterbi decode with blind
antenna/phase trials) and 36.212 §5.3.1 / 36.211 §6.6.

All four frame-phase hypotheses x antenna masks are decoded as
one batched Viterbi call (hypotheses ride the batch axis); CRC16 selects the
winner — the reference's sequential blind loop becomes a single wide decode.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import jax.numpy as jnp

from ..config import FrameParms
from ..ops.crc import crc_bits_host, crc_matrix
from ..ops.gold import gold_sequence
from ..ops.convcode import conv_encode_host, viterbi_decode
from ..ops.rate_match import make_cc_rate_match_maps, cc_rate_match_rx

MIB_LEN = 24
_K = MIB_LEN + 16          # 40 bits into the CC
_E_NCP = 1920              # rate-matched bits, normal CP (4 frames x 480)

# CRC masks per antenna count (36.212 §5.3.1.1)
_ANT_MASK = {1: np.zeros(16, np.int8),
             2: np.ones(16, np.int8),
             4: np.tile([0, 1], 8).astype(np.int8)}

_BW_TABLE = (6, 15, 25, 50, 75, 100)


def pack_mib(n_rb: int, sfn: int, phich_dur: int = 0,
             phich_res: int = 0) -> np.ndarray:
    """MIB a(0..23): bw(3) | phich_dur(1) | phich_res(2) | SFN[9:2](8) |
    spare(10) (36.331 MasterInformationBlock)."""
    bits = np.zeros(MIB_LEN, np.int8)
    bw = _BW_TABLE.index(n_rb)
    bits[0:3] = [(bw >> (2 - i)) & 1 for i in range(3)]
    bits[3] = phich_dur & 1
    bits[4:6] = [(phich_res >> (1 - i)) & 1 for i in range(2)]
    sfn8 = (sfn >> 2) & 0xFF
    bits[6:14] = [(sfn8 >> (7 - i)) & 1 for i in range(8)]
    return bits


def unpack_mib(bits: np.ndarray) -> dict:
    bw = int(bits[0]) * 4 + int(bits[1]) * 2 + int(bits[2])
    sfn8 = 0
    for i in range(8):
        sfn8 = (sfn8 << 1) | int(bits[6 + i])
    return dict(n_rb=_BW_TABLE[bw] if bw < 6 else None,
                phich_dur=int(bits[3]),
                phich_res=int(bits[4]) * 2 + int(bits[5]),
                sfn_msb8=sfn8)


def pbch_encode(mib_bits: np.ndarray, n_ant: int = 1) -> np.ndarray:
    """MIB -> 1920 coded bits (host precompute; one 40 ms period)."""
    crc = crc_bits_host(mib_bits, "crc16") ^ _ANT_MASK[n_ant]
    b = np.concatenate([mib_bits.astype(np.int8), crc])
    d = conv_encode_host(b)                      # [3, 40]
    maps = make_cc_rate_match_maps(_K, _E_NCP)
    return d.reshape(-1)[maps.e_src]


@functools.lru_cache(maxsize=None)
def pbch_scramble_seq(nid_cell: int) -> np.ndarray:
    """Gold sequence over the 40 ms PBCH period (36.211 §6.6.1)."""
    return gold_sequence(nid_cell, _E_NCP).astype(np.int8)


@dataclass(frozen=True)
class PbchMap:
    """RE coordinates of one frame's PBCH quarter (240 QPSK symbols)."""
    sym: np.ndarray       # subframe-0 symbol indices (slot 1 => 7..10)
    sc: np.ndarray        # occupied-grid subcarrier indices
    bins: np.ndarray


@functools.lru_cache(maxsize=None)
def make_pbch_map(n_rb: int, nid_cell: int = 0,
                  normal_cp: bool = True) -> PbchMap:
    """Center 72 SCs on slot-1 symbols 0..3; symbols 0/1 skip the 4-port RS
    lattice (k = nushift mod 3, spacing 3) => 48+48+72+72 = 240 REs."""
    fp = FrameParms(n_rb=n_rb, normal_cp=normal_cp, n_id_cell=nid_cell)
    base = 6 * n_rb - 36
    rs_mod3 = nid_cell % 3
    sym_l, sc_l = [], []
    nsps = fp.symbols_per_slot
    for l in range(4):
        sym = nsps + l
        for k in range(72):
            if l < 2 and (k % 3) == rs_mod3:
                continue
            sym_l.append(sym)
            sc_l.append(base + k)
    sym = np.asarray(sym_l, np.int32)
    sc = np.asarray(sc_l, np.int32)
    return PbchMap(sym=sym, sc=sc, bins=fp.sc_to_bin(sc))


def pbch_frame_symbols(mib_bits: np.ndarray, nid_cell: int, frame_phase: int,
                       n_ant: int = 1) -> np.ndarray:
    """QPSK symbols [240] for radio frame (sfn mod 4 == frame_phase)."""
    e = pbch_encode(mib_bits, n_ant)
    b = e ^ pbch_scramble_seq(nid_cell)
    q = b[480 * frame_phase: 480 * (frame_phase + 1)].astype(np.float64)
    s = ((1 - 2 * q[0::2]) + 1j * (1 - 2 * q[1::2])) / np.sqrt(2)
    return s.astype(np.complex64)


def pbch_blind_decode(llr480, nid_cell: int, n_ant_hyps=(1, 2)):
    """Blind-decode one frame's PBCH quarter.

    llr480: [B, 480] LLRs (positive <=> bit 0) of the received quarter.
    Tries all 4 frame phases as a batched hypothesis axis; CRC16 (per antenna
    mask) picks the winner. Returns (ok [B], mib_bits [B, 24],
    phase [B], n_ant [B]).
    """
    B = llr480.shape[0]
    seq = pbch_scramble_seq(nid_cell).astype(np.float32)
    maps = make_cc_rate_match_maps(_K, _E_NCP)

    # build per-phase descrambled full-length-E LLR (unseen positions = 0)
    hyp_llrs = []
    for ph in range(4):
        sgn = jnp.asarray(1.0 - 2.0 * seq[480 * ph: 480 * (ph + 1)])
        e = jnp.zeros((B, _E_NCP), llr480.dtype)
        e = e.at[:, 480 * ph: 480 * (ph + 1)].set(llr480 * sgn)
        hyp_llrs.append(e)
    e_all = jnp.concatenate(hyp_llrs, axis=0)          # [4B, 1920]
    d_llr = cc_rate_match_rx(e_all, maps)              # [4B, 3, 40]
    bits = viterbi_decode(d_llr, _K)                   # [4B, 40]

    # CRC16 check per antenna mask, on device (GF(2) matmul)
    M = jnp.asarray(crc_matrix(MIB_LEN, "crc16"))      # [24, 16]
    payload = bits[:, :MIB_LEN]
    crc_calc = (payload.astype(jnp.int32) @ M.astype(jnp.int32)) % 2
    crc_rx = bits[:, MIB_LEN:].astype(jnp.int32)
    oks, ants = [], []
    for na in n_ant_hyps:
        mask = jnp.asarray(_ANT_MASK[na].astype(np.int32))
        oks.append(jnp.all((crc_calc ^ mask) == crc_rx, axis=-1))
        ants.append(na)
    ok_h = jnp.stack(oks, axis=0)                      # [n_ant_hyp, 4B]
    ant_idx = jnp.argmax(ok_h, axis=0)
    ok_any = jnp.any(ok_h, axis=0)                     # [4B]

    ok_p = ok_any.reshape(4, B)
    phase = jnp.argmax(ok_p, axis=0)                   # [B]
    ok = jnp.any(ok_p, axis=0)
    sel = phase * B + jnp.arange(B)
    mib = payload[sel]
    ant = jnp.asarray(np.asarray(n_ant_hyps, np.int32))[ant_idx[sel]]
    return ok, mib, phase, ant
