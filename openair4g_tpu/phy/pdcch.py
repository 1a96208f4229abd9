"""PDCCH/DCI + PCFICH: control-channel coding and blind decoding.

Reference parity: openair1/PHY/LTE_TRANSPORT/dci.c (generate_dci_top /
dci_decoding :2426 / dci_decoding_procedure :2788 — blind search over
aggregation levels L in {1,2,4,8} in common + UE-specific search spaces) and
pcfich.c (CFI encode/decode, 36.212 §5.3.4 codewords); 36.212 §5.3.3 (DCI:
CRC16 masked by RNTI, tail-biting CC, rate matching to 72·L bits) and
36.211 §6.8 (CCE = 9 REGs = 36 REs, QPSK).

The blind search decodes ALL candidate (L, CCE-offset) hypotheses
as one batched Viterbi call — hypotheses are rows of a single [B·n_hyp, ...]
decode, the RNTI-masked CRC picks winners. The reference's nested loops over
search spaces become one gather + one wide decode.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import jax.numpy as jnp

from ..ops.crc import crc_bits_host, crc_matrix
from ..ops.convcode import conv_encode_host, viterbi_decode
from ..ops.rate_match import make_cc_rate_match_maps, cc_rate_match_rx
from ..ops.gold import gold_sequence

RE_PER_CCE = 36          # 9 REGs x 4 REs
BITS_PER_CCE = 72        # QPSK

# 36.212 Table 5.3.4-1: the 32-bit PCFICH codewords for CFI 1..3
_CFI_CODEWORDS = np.array([
    [0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0,
     1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1],
    [1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1,
     0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0],
    [1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1,
     1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1]], np.int8)


def cfi_encode(cfi: int) -> np.ndarray:
    """CFI (1..3) -> 32 bits."""
    return _CFI_CODEWORDS[cfi - 1]


def cfi_decode(llr32):
    """llr32 [B, 32] (positive <=> bit 0) -> (cfi [B] in 1..3, corr [B, 3])."""
    sgn = jnp.asarray(1.0 - 2.0 * _CFI_CODEWORDS.astype(np.float32))  # [3,32]
    corr = llr32 @ sgn.T
    return jnp.argmax(corr, axis=-1) + 1, corr


# ---------------------------------------------------------------------------
# DCI payload formats (subset: the sizes matter for coding; field semantics
# mirror dci_tools.c's generate_eNB_dlsch_params_from_dci for format 1A/0)
# ---------------------------------------------------------------------------

def dci_format1a_size(n_rb_dl: int, tdd: bool = False) -> int:
    """Format 1A payload bits (VRB flag + RIV + MCS5 + HARQ + NDI + RV2 +
    TPC2), padded per 36.212 §5.3.3.1.3. TDD variants carry a 4-bit HARQ
    process number and a 2-bit Downlink Assignment Index (the reference's
    DCI1A_*_TDD_1_6_t structs vs the FDD ones, dci.h)."""
    import math
    riv = math.ceil(math.log2(n_rb_dl * (n_rb_dl + 1) / 2))
    size = 1 + riv + 5 + (4 if tdd else 3) + 1 + 2 + 2 + (2 if tdd else 0)
    # +1 if size equals an ambiguous format-0 size (simplified: pad to even)
    return size


def pack_dci_format1a(n_rb_dl: int, rb_start: int, n_prb: int, mcs: int,
                      harq_pid: int, ndi: int, rv: int, tpc: int = 0,
                      tdd: bool = False, dai: int = 0) -> np.ndarray:
    """Pack a format-1A DCI (localized VRB). RIV = N(L-1)+s for L-1 <= N/2.
    tdd=True appends the TDD fields (4-bit HARQ, 2-bit DAI)."""
    import math
    nriv = math.ceil(math.log2(n_rb_dl * (n_rb_dl + 1) / 2))
    assert 1 <= n_prb <= n_rb_dl - rb_start
    if (n_prb - 1) <= n_rb_dl // 2:
        riv = n_rb_dl * (n_prb - 1) + rb_start
    else:
        riv = n_rb_dl * (n_rb_dl - n_prb + 1) + (n_rb_dl - 1 - rb_start)
    fields = [(1, 1),            # localized VRB
              (riv, nriv), (mcs, 5), (harq_pid, 4 if tdd else 3), (ndi, 1),
              (rv, 2), (tpc, 2)]
    if tdd:
        fields.append((dai, 2))
    bits = []
    for val, width in fields:
        bits += [(val >> (width - 1 - i)) & 1 for i in range(width)]
    return np.asarray(bits, np.int8)


def unpack_dci_format1a(bits: np.ndarray, n_rb_dl: int,
                        tdd: bool = False) -> dict:
    import math
    nriv = math.ceil(math.log2(n_rb_dl * (n_rb_dl + 1) / 2))
    it = iter(range(len(bits)))

    def take(w):
        v = 0
        for _ in range(w):
            v = (v << 1) | int(bits[next(it)])
        return v

    loc = take(1)
    riv = take(nriv)
    mcs, harq = take(5), take(4 if tdd else 3)
    ndi, rv, tpc = take(1), take(2), take(2)
    out = dict(vrb_localized=loc, mcs=mcs,
               harq_pid=harq, ndi=ndi, rv=rv, tpc=tpc)
    if tdd:
        out["dai"] = take(2)
    lcrb = riv // n_rb_dl + 1
    rb_start = riv % n_rb_dl
    if rb_start + lcrb > n_rb_dl:
        lcrb = n_rb_dl - lcrb + 2
        rb_start = n_rb_dl - 1 - rb_start
    out.update(rb_start=rb_start, n_prb=lcrb)
    return out


# ---------------------------------------------------------------------------
# DCI encoding + blind decoding
# ---------------------------------------------------------------------------

def dci_encode(payload: np.ndarray, rnti: int, L: int) -> np.ndarray:
    """payload [A] -> coded bits [72*L] (CRC16 xor RNTI, TBCC, rate match)."""
    crc = crc_bits_host(payload, "crc16")
    rnti_bits = np.array([(rnti >> (15 - i)) & 1 for i in range(16)], np.int8)
    b = np.concatenate([payload.astype(np.int8), crc ^ rnti_bits])
    d = conv_encode_host(b)
    maps = make_cc_rate_match_maps(len(b), BITS_PER_CCE * L)
    return d.reshape(-1)[maps.e_src]


def pdcch_scramble_seq(nid_cell: int, ns: int, length: int) -> np.ndarray:
    """36.211 §6.8.2: c_init = (ns/2)*2^9 + Nid."""
    cinit = ((ns // 2) << 9) + nid_cell
    return gold_sequence(cinit, length).astype(np.int8)


@dataclass(frozen=True)
class DciCandidate:
    L: int
    cce_offset: int


def search_space_candidates(n_cce: int) -> list:
    """Exhaustive sweep over every aggregation/offset (a superset of any
    hash-limited search space — maximal detection, more false-alarm
    hypotheses). Kept for sims that don't model a UE identity; the
    spec-exact spaces are ue_search_candidates/common_search_candidates."""
    cands = []
    for L in (1, 2, 4, 8):
        for off in range(0, n_cce - L + 1, L):
            cands.append(DciCandidate(L=L, cce_offset=off))
    return cands


def yk_hash(rnti: int, subframe: int) -> int:
    """36.213 §9.1.1 UE-specific search-space hash Y_k: Y_-1 = n_RNTI,
    Y_k = (39827 * Y_{k-1}) mod 65537, iterated k = 0..subframe (the
    reference's loop at dci.c:2592-2594)."""
    y = rnti
    for _ in range(subframe + 1):
        y = (y * 39827) % 65537
    return y


def ue_search_candidates(n_cce: int, rnti: int, subframe: int) -> list:
    """UE-specific search space, 36.213 Table 9.1.1-1: M(L) = 6/6/2/2
    candidates at L = 1/2/4/8, offsets L*((Yk + m) mod floor(nCCE/L))."""
    cands, seen = [], set()
    for L, M in ((1, 6), (2, 6), (4, 2), (8, 2)):
        if n_cce < L:
            continue
        m_max = min(M, n_cce // L)
        yk = yk_hash(rnti, subframe) % (n_cce // L)
        for m in range(m_max):
            off = L * ((yk + m) % (n_cce // L))
            if (L, off) not in seen:
                seen.add((L, off))
                cands.append(DciCandidate(L=L, cce_offset=off))
    return cands


def common_search_candidates(n_cce: int) -> list:
    """Common search space (SI-RNTI/RA-RNTI/P-RNTI/TPC): L=4 x 4 and
    L=8 x 2 candidates at fixed offsets from CCE 0 (dci.c:2585-2587)."""
    cands = []
    for L, M in ((4, 4), (8, 2)):
        for m in range(M):
            off = L * m
            if off + L <= n_cce:
                cands.append(DciCandidate(L=L, cce_offset=off))
    return cands


def dci_blind_decode(llr_cces, payload_len: int, rnti: int,
                     candidates: list):
    """Blind-decode all candidates for one DCI payload size.

    llr_cces: [B, n_cce * 72] control-region LLRs (descrambled).
    Returns (found [B], payload_bits [B, payload_len], cand_idx [B]).
    """
    B = llr_cces.shape[0]
    K = payload_len + 16
    rnti_bits = np.array([(rnti >> (15 - i)) & 1 for i in range(16)],
                         np.int32)

    d_all = []
    for c in candidates:
        E = BITS_PER_CCE * c.L
        maps = make_cc_rate_match_maps(K, E)
        s = c.cce_offset * BITS_PER_CCE
        e = llr_cces[:, s:s + E]
        d_all.append(cc_rate_match_rx(e, maps))
    d = jnp.concatenate(d_all, axis=0)                   # [n_cand*B, 3, K]
    bits = viterbi_decode(d, K)                          # [n_cand*B, K]

    M = jnp.asarray(crc_matrix(payload_len, "crc16"), jnp.int32)
    crc_calc = (bits[:, :payload_len].astype(jnp.int32) @ M) % 2
    crc_rx = bits[:, payload_len:].astype(jnp.int32)
    ok = jnp.all((crc_calc ^ jnp.asarray(rnti_bits)) == crc_rx, axis=-1)

    ok_c = ok.reshape(len(candidates), B)                # [n_cand, B]
    cand_idx = jnp.argmax(ok_c, axis=0)
    found = jnp.any(ok_c, axis=0)
    sel = cand_idx * B + jnp.arange(B)
    payload = bits[sel][:, :payload_len]
    return found, payload, cand_idx
