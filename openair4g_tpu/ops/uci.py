"""UCI on PUSCH: CQI/RI/ACK coding, dimensioning and channel multiplexing,
3GPP TS 36.212 §5.2.2.6-5.2.2.8.

Reference parity (behavior, not code):
  - openair1/PHY/LTE_TRANSPORT/ulsch_coding.c:448-940 — Q' dimensioning,
    q_RI/q_ACK placeholder encodings (PUSCH_x/PUSCH_y), CQI CC coding with
    CRC8, and the Cmux x Rmux' channel interleaver with RI column set
    {1,4,7,10} and ACK puncture columns {2,3,8,9} (vars.h:74-77).
  - openair1/PHY/LTE_TRANSPORT/ulsch_decoding.c:230-1418 — control
    demultiplexing and CQI conv decode + CRC8 check (extract_cqi_crc :208).

Design: the interleaver is resolved ONCE on the host into static
index maps over *modulation symbols* of the [C_sym, M_sc] PUSCH data grid
(flat index p = sym*M + r, matching scfdma.pusch_fill_grid layout, i.e. the
reference's column-major read of its row-major y[] matrix). TX is then pure
scatters of complex symbols; RX is pure gathers of LLRs; ACK puncturing of
data is a static zero-mask. RI/ACK placeholder bits (x=1, y=repeat) are
realized at the constellation level: each RI/ACK modulation symbol is drawn
from the maximum-distance corner subset, exactly the effect the spec's
x/y scrambling rules produce — these symbols bypass scrambling.

CQI coding: O <= 11 payload bits use the (32, O) Reed-Muller block code of
36.212 Table 5.2.2.6.4-1 with circular repetition (the reference rejects
this range, ulsch_coding.c:568 "short CQI sizes not supported yet" — we
support it); O >= 12 uses CRC8 + rate-1/3 tail-biting CC + CC rate matching,
the reference's only path. RM decode is ML: one [2^O, 32] codebook
matmul; CC decode is the batched Viterbi of ops/convcode.py.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import jax.numpy as jnp

from .crc import crc_bits_host, crc_matrix
from .convcode import conv_encode_host, viterbi_decode
from .rate_match import make_cc_rate_match_maps, cc_rate_match_tx, \
    cc_rate_match_rx
from ..tables.modulation import mod_table

# 36.212 Table 5.2.2.6.4-1: basis sequences M_{i,n} of the (32, O<=11) code.
RM32_BASIS = np.array([
    [1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 1],
    [1, 1, 1, 0, 0, 0, 0, 0, 0, 1, 1],
    [1, 0, 0, 1, 0, 0, 1, 0, 1, 1, 1],
    [1, 0, 1, 1, 0, 0, 0, 0, 1, 0, 1],
    [1, 1, 1, 1, 0, 0, 0, 1, 0, 0, 1],
    [1, 1, 0, 0, 1, 0, 1, 1, 1, 0, 1],
    [1, 0, 1, 0, 1, 0, 1, 0, 1, 1, 1],
    [1, 0, 0, 1, 1, 0, 0, 1, 1, 0, 1],
    [1, 1, 0, 1, 1, 0, 0, 1, 0, 1, 1],
    [1, 0, 1, 1, 1, 0, 1, 0, 0, 1, 1],
    [1, 0, 1, 0, 0, 1, 1, 1, 0, 1, 1],
    [1, 1, 1, 0, 0, 1, 1, 0, 1, 0, 1],
    [1, 0, 0, 1, 0, 1, 0, 1, 1, 1, 1],
    [1, 1, 0, 1, 0, 1, 0, 1, 0, 1, 1],
    [1, 0, 0, 0, 1, 1, 0, 1, 0, 0, 1],
    [1, 1, 0, 0, 1, 1, 1, 1, 0, 1, 1],
    [1, 1, 1, 0, 1, 1, 1, 0, 0, 1, 0],
    [1, 0, 0, 1, 1, 1, 0, 0, 1, 0, 0],
    [1, 1, 0, 1, 1, 1, 1, 1, 0, 0, 0],
    [1, 0, 0, 0, 0, 1, 1, 0, 0, 0, 0],
    [1, 0, 1, 0, 0, 0, 1, 0, 0, 0, 1],
    [1, 1, 0, 1, 0, 0, 0, 0, 0, 1, 1],
    [1, 0, 0, 0, 1, 0, 0, 1, 1, 0, 1],
    [1, 1, 1, 0, 1, 0, 0, 0, 1, 1, 1],
    [1, 1, 1, 1, 1, 0, 1, 1, 1, 1, 0],
    [1, 1, 0, 0, 0, 1, 1, 1, 0, 0, 1],
    [1, 0, 1, 1, 0, 1, 0, 0, 1, 1, 0],
    [1, 1, 1, 1, 0, 1, 0, 1, 1, 1, 0],
    [1, 0, 1, 0, 1, 1, 1, 0, 1, 0, 0],
    [1, 0, 1, 1, 1, 1, 1, 1, 1, 0, 0],
    [1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1],
    [1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
], np.int8)

# Column sets of the channel interleaver (36.212 Tables 5.2.2.8-1/2;
# reference vars.h:74-77). Visit order cycles j -> (j+3) & 3, i.e.
# {c0, c3, c2, c1} (ulsch_coding.c:766 "j=(j+3)&3").
CS_RI = {True: (1, 4, 7, 10), False: (0, 3, 5, 8)}     # normal / extended CP
CS_ACK = {True: (2, 3, 8, 9), False: (1, 2, 6, 7)}


# ----------------------------------------------------------- dimensioning --

@dataclass(frozen=True)
class UciConfig:
    """UCI payload riding on one PUSCH (36.213 beta offsets as linear)."""
    o_cqi: int = 0          # CQI/PMI payload bits
    o_ri: int = 0           # 0 or 1
    o_ack: int = 0          # 0, 1 or 2
    beta_cqi: float = 2.0
    beta_ri: float = 2.0
    beta_ack: float = 2.0

    @property
    def any(self) -> bool:
        return (self.o_cqi + self.o_ri + self.o_ack) > 0


@dataclass(frozen=True)
class UciMaps:
    """Static multiplexing plan for one (PUSCH alloc, MCS, UCI) tuple.

    All *_pos arrays are flat modulation-symbol indices into the [C, M]
    data grid (p = sym*M + subcarrier-row).
    """
    Qm: int
    C: int                   # SC-FDMA data symbols (Cmux)
    M: int                   # subcarriers (Rmux')
    qp_cqi: int              # CQI modulation symbols
    qp_ri: int
    qp_ack: int
    G_data: int              # UL-SCH coded bits after CQI/RI reservation
    Q_cqi: int               # CQI coded bits
    cqi_pos: np.ndarray      # [qp_cqi]
    data_pos: np.ndarray     # [G_data // Qm]
    ri_pos: np.ndarray       # [qp_ri]
    ack_pos: np.ndarray      # [qp_ack]
    data_keep: np.ndarray    # bool [G_data] — False where ACK punctured


def _q_prime(O: int, msc: int, nsymb: int, beta: float,
             sum_kr: int) -> int:
    """Q' = min(ceil(O * Msc_initial * Nsymb_initial * beta / sum(Kr)),
    4 * Msc) (36.212 §5.2.2.6; ulsch_coding.c:448-520)."""
    if O == 0:
        return 0
    q = -(-(O * msc * nsymb * int(round(beta * 1000))) // (1000 * sum_kr))
    return min(q, 4 * msc)


def _mat_to_grid(r: np.ndarray, c: np.ndarray, C: int, M: int) -> np.ndarray:
    """(row, col) of the interleaver matrix -> flat [C, M] grid symbol."""
    return (c * M + r).astype(np.int32)


@functools.lru_cache(maxsize=None)
def make_uci_maps(m_sc: int, n_data_sym: int, Qm: int, sum_kr: int,
                  o_cqi: int, o_ri: int, o_ack: int,
                  beta_cqi: float, beta_ri: float, beta_ack: float,
                  normal_cp: bool = True) -> UciMaps:
    """Resolve 36.212 §5.2.2.7/5.2.2.8 into static index maps."""
    C, M = n_data_sym, m_sc
    H_sym = C * M                                      # total symbols

    qp_ri = _q_prime(o_ri, m_sc, n_data_sym, beta_ri, sum_kr)
    qp_ack = _q_prime(o_ack, m_sc, n_data_sym, beta_ack, sum_kr)
    L = 8 if o_cqi >= 12 else 0
    qp_cqi = _q_prime(o_cqi + L, m_sc, n_data_sym, beta_cqi, sum_kr) \
        if o_cqi else 0
    # keep at least one symbol of data
    qp_cqi = min(qp_cqi, H_sym - qp_ri - 1) if o_cqi else 0

    n_data_syms = H_sym - qp_ri - qp_cqi
    G_data = n_data_syms * Qm
    Q_cqi = qp_cqi * Qm

    # RI positions: bottom-up rows, columns cycling {c0,c3,c2,c1}
    cs_ri = CS_RI[normal_cp]
    j_order = (0, 3, 2, 1)
    i = np.arange(qp_ri)
    ri_r = M - 1 - (i >> 2)
    ri_c = np.asarray([cs_ri[j_order[k & 3]] for k in i], np.int64) \
        if qp_ri else np.zeros(0, np.int64)
    ri_pos = _mat_to_grid(ri_r, ri_c, C, M) if qp_ri else \
        np.zeros(0, np.int32)

    # CQI then data fill the matrix row-major, skipping RI holes
    occupied = np.zeros((M, C), bool)
    if qp_ri:
        occupied[ri_r, ri_c] = True
    free_rm = np.nonzero(~occupied.reshape(-1))[0]     # row-major flat r*C+c
    assert len(free_rm) == n_data_syms + qp_cqi
    fr, fc = free_rm // C, free_rm % C
    free_grid = _mat_to_grid(fr, fc, C, M)
    cqi_pos = free_grid[:qp_cqi]
    data_pos = free_grid[qp_cqi:]

    # ACK overwrites (punctures) whatever sits at its positions
    i = np.arange(qp_ack)
    cs_ack = CS_ACK[normal_cp]
    ack_r = M - 1 - (i >> 2)
    ack_c = np.asarray([cs_ack[j_order[k & 3]] for k in i], np.int64) \
        if qp_ack else np.zeros(0, np.int64)
    ack_pos = _mat_to_grid(ack_r, ack_c, C, M) if qp_ack else \
        np.zeros(0, np.int32)

    punched = np.isin(data_pos, ack_pos)
    data_keep = np.repeat(~punched, Qm)
    return UciMaps(Qm=Qm, C=C, M=M, qp_cqi=qp_cqi, qp_ri=qp_ri,
                   qp_ack=qp_ack, G_data=G_data, Q_cqi=Q_cqi,
                   cqi_pos=cqi_pos.astype(np.int32),
                   data_pos=data_pos.astype(np.int32),
                   ri_pos=ri_pos, ack_pos=ack_pos, data_keep=data_keep)


# ------------------------------------------------------------- CQI coding --

@functools.lru_cache(maxsize=None)
def _rm32_codebook(O: int) -> np.ndarray:
    """[2^O, 32] all codewords of the (32, O) code (for the matmul ML decode)."""
    assert 1 <= O <= 11
    msgs = ((np.arange(1 << O)[:, None] >> np.arange(O)) & 1).astype(np.int8)
    return (msgs @ RM32_BASIS[:, :O].T) % 2


def cqi_encode_host(bits: np.ndarray, Q_cqi: int) -> np.ndarray:
    """CQI payload [O] -> coded bits [Q_cqi] (host; payload is host data)."""
    O = len(bits)
    if O <= 11:
        code = (RM32_BASIS[:, :O] @ np.asarray(bits, np.int64)) % 2
        reps = -(-Q_cqi // 32)
        return np.tile(code, reps)[:Q_cqi].astype(np.int8)
    # CC path (reference: crc8 + ccodelte_encode + lte_rate_matching_cc)
    with_crc = np.concatenate([bits, crc_bits_host(bits, "crc8")])
    d = conv_encode_host(with_crc).reshape(-1)               # [3*(O+8)]
    maps = make_cc_rate_match_maps(O + 8, Q_cqi)
    return np.asarray(d, np.int8)[maps.e_src]


def cqi_encode_device(bits, Q_cqi: int):
    """Batched CQI encode. bits [B, O] -> coded [B, Q_cqi] int32."""
    from .crc import crc_device
    from .convcode import conv_encode_device
    B, O = bits.shape
    if O <= 11:
        basis = jnp.asarray(RM32_BASIS[:, :O].astype(np.float32))
        code = jnp.mod(jnp.matmul(bits.astype(jnp.float32), basis.T,
                                  preferred_element_type=jnp.float32), 2.0)
        code = code.astype(jnp.int32)                       # [B, 32]
        reps = -(-Q_cqi // 32)
        return jnp.tile(code, (1, reps))[:, :Q_cqi]
    crc = jnp.round(crc_device(bits, "crc8")).astype(jnp.int32)
    with_crc = jnp.concatenate([bits.astype(jnp.int32), crc], axis=1)
    d = conv_encode_device(with_crc).reshape(B, -1)         # [B, 3*(O+8)]
    maps = make_cc_rate_match_maps(O + 8, Q_cqi)
    return d[:, jnp.asarray(maps.e_src)].astype(jnp.int32)


def cqi_decode(llr, O: int):
    """Coded-bit LLRs [B, Q_cqi] -> (bits [B, O], ok [B]).

    O <= 11: ML correlation against the full codebook (one matmul).
    O >= 12: CC rate-dematch + tail-biting Viterbi + CRC8 check.
    """
    B, Q = llr.shape
    if O <= 11:
        reps = -(-Q // 32)
        pad = jnp.zeros((B, reps * 32 - Q), llr.dtype)
        folded = jnp.concatenate([llr, pad], axis=1).reshape(B, reps, 32)
        folded = folded.sum(axis=1)                         # [B, 32]
        cb = jnp.asarray(1.0 - 2.0 * _rm32_codebook(O), jnp.float32)
        scores = jnp.matmul(folded, cb.T,
                            preferred_element_type=jnp.float32)
        best = jnp.argmax(scores, axis=-1)
        bits = (best[:, None] >> jnp.arange(O)) & 1
        return bits.astype(jnp.int32), jnp.ones(B, bool)
    maps = make_cc_rate_match_maps(O + 8, Q)
    d_llr = cc_rate_match_rx(llr, maps)                     # [B, 3, O+8]
    bits = viterbi_decode(d_llr, O + 8)                     # [B, O+8]
    H = jnp.asarray(crc_matrix(O + 8, "crc8"), jnp.float32)
    rem = jnp.mod(jnp.matmul(bits.astype(jnp.float32), H,
                             preferred_element_type=jnp.float32), 2.0)
    ok = jnp.all(rem < 0.5, axis=-1)
    return bits[:, :O], ok


# ------------------------------------------------ RI/ACK symbol-level code --

def _corner_symbol(Qm: int, b0, b1):
    """Constellation point for bit vector [b0, b1, 1, 1, ...] — the
    maximum-energy corner selected by the spec's x-placeholder rule."""
    table = mod_table(Qm)
    idx_base = int(np.sum(1 << np.arange(Qm - 3, -1, -1))) if Qm > 2 else 0
    # index = b0*2^(Qm-1) + b1*2^(Qm-2) + (all ones below)
    tab = jnp.asarray(table)
    idx = b0 * (1 << (Qm - 1)) + b1 * (1 << (Qm - 2)) + idx_base
    return tab[idx]


def uci1_symbols(o, Qm: int, qp: int):
    """1-bit RI/ACK -> [B, qp] modulation symbols ([o, y=o, x...] repeated,
    ulsch_coding.c:602-628)."""
    s = _corner_symbol(Qm, o, o)                            # [B]
    return jnp.broadcast_to(s[:, None], (s.shape[0], qp))


def uci2_symbols(o, Qm: int, qp: int):
    """2-bit ACK -> [B, qp] symbols: triplet (o0,o1),(o2,o0),(o1,o2) with
    o2 = o0^o1, cycled (ulsch_coding.c:672-745)."""
    o0, o1 = o[:, 0], o[:, 1]
    o2 = jnp.bitwise_xor(o0, o1)
    trip = jnp.stack([_corner_symbol(Qm, o0, o1),
                      _corner_symbol(Qm, o2, o0),
                      _corner_symbol(Qm, o1, o2)], axis=1)  # [B, 3]
    idx = jnp.asarray(np.arange(qp) % 3)
    return trip[:, idx]


def uci1_decode(sym_llr2):
    """Per-symbol (b0, b1) LLRs [B, qp, 2] -> bit [B] (0/1) for 1-bit UCI."""
    m = sym_llr2.sum(axis=(1, 2))
    return (m < 0).astype(jnp.int32)


def uci2_decode(sym_llr2):
    """[B, qp, 2] -> 2-bit ACK [B, 2] by ML over the 4 hypotheses."""
    B, qp, _ = sym_llr2.shape
    # symbol k carries bits (pattern[k%3]) of (o0, o1, o2)
    pat = np.array([[0, 1], [2, 0], [1, 2]])
    hyp = []
    for h in range(4):
        o = np.array([h & 1, (h >> 1) & 1])
        o = np.append(o, o[0] ^ o[1])                       # [3]
        signs = 1.0 - 2.0 * o[pat[np.arange(qp) % 3]]       # [qp, 2]
        hyp.append(signs)
    Hs = jnp.asarray(np.stack(hyp), jnp.float32)            # [4, qp, 2]
    scores = jnp.einsum("bqk,hqk->bh", sym_llr2, Hs)
    best = jnp.argmax(scores, axis=-1)
    return jnp.stack([best & 1, (best >> 1) & 1], axis=-1).astype(jnp.int32)


# ------------------------------------------------------------ multiplexing --

def uci_multiplex(data_sym, cqi_sym, ri_sym, ack_sym, maps: UciMaps):
    """Scatter modulation symbols into the [B, C, M] PUSCH data grid.

    data_sym [B, G_data/Qm], cqi_sym [B, qp_cqi] (or None), ri/ack_sym
    [B, qp] (or None). Replaces scfdma.PuschMap.interleave for UCI frames —
    the data_pos order already encodes the row-major/column-read interleave.
    """
    B = data_sym.shape[0]
    y = jnp.zeros((B, maps.C * maps.M), jnp.complex64)
    y = y.at[:, jnp.asarray(maps.data_pos)].set(data_sym)
    if maps.qp_cqi:
        y = y.at[:, jnp.asarray(maps.cqi_pos)].set(cqi_sym)
    if maps.qp_ri:
        y = y.at[:, jnp.asarray(maps.ri_pos)].set(ri_sym)
    if maps.qp_ack:
        y = y.at[:, jnp.asarray(maps.ack_pos)].set(ack_sym)
    return y.reshape(B, maps.C, maps.M)


def uci_demultiplex(llr_grid, maps: UciMaps):
    """llr_grid [B, C, M, Qm] per-symbol LLRs -> dict of streams:
    data [B, G_data] (ACK-punctured positions zeroed), cqi [B, Q_cqi],
    ri/ack [B, qp, 2] (first two bit positions of each UCI symbol)."""
    B = llr_grid.shape[0]
    flat = llr_grid.reshape(B, maps.C * maps.M, maps.Qm)
    data = flat[:, jnp.asarray(maps.data_pos)].reshape(B, -1)
    data = data * jnp.asarray(maps.data_keep, jnp.float32)
    out = {"data": data}
    if maps.qp_cqi:
        out["cqi"] = flat[:, jnp.asarray(maps.cqi_pos)].reshape(B, -1)
    if maps.qp_ri:
        out["ri"] = flat[:, jnp.asarray(maps.ri_pos)][..., :2]
    if maps.qp_ack:
        out["ack"] = flat[:, jnp.asarray(maps.ack_pos)][..., :2]
    return out
