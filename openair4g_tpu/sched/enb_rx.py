"""eNB per-subframe RX procedures: PRACH + PUSCH + PUCCH + SRS receiver
and HARQ feedback bookkeeping.

Reference parity: openair1/SCHED/phy_procedures_lte_eNb.c:3207
(phy_procedures_eNB_RX — prach_procedures :3070, per-UE rx_ulsch +
ulsch_decoding, rx_pucch, SRS estimates), process_HARQ_feedback :2658 and
the UE-drop rule after ULSCH_max_consecutive_errors :1415-1422.

The whole uplink subframe of a batch of cells/trials is one
grid; each channel's receiver is a static-gather + batched kernel; HARQ
state (round counters, consecutive-error drop) is small host bookkeeping
exactly like the reference's eNB structs.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import jax.numpy as jnp

from ..config import FrameParms
from ..phy.pusch import make_ul_wiener, ul_estimate_channel, \
    scfdma_mmse_equalize
from ..phy.scfdma import pusch_extract, transform_deprecode, remove_7_5_khz
from ..phy.srs import srs_estimate
from ..phy.pucch import pucch1_detect, DATA_SYMS_F1, RS_SYMS_F1
from ..phy import ofdm
from ..ops.gold import unscramble_llrs
from ..ops.llr import demap_llr


class EnbRx:
    """Uplink receiver bound to one UeTx configuration (grant knowledge)."""

    def __init__(self, ue_tx):
        self.tx = ue_tx            # sched.ue_tx.UeTx — shares maps/codec
        self.fp = ue_tx.fp
        self.pm = ue_tx.pm
        self.codec = ue_tx.codec

    def receive_pusch(self, waveform, n0, wiener=None):
        """waveform [B, samples] -> (tb [B, TBS], ok [B], srs stats|None)."""
        cfg = self.tx.cfg
        t = remove_7_5_khz(waveform, self.fp)
        rgrid = ofdm.ofdm_demodulate(t, self.fp)
        y, dmrs_rx = pusch_extract(rgrid, self.pm)
        if wiener is None:
            wiener = jnp.asarray(make_ul_wiener(self.pm, float(n0)))
        H = ul_estimate_channel(dmrs_rx, self.tx.dmrs, self.pm, wiener)
        xf, n0_eff = scfdma_mmse_equalize(y, H, n0)
        x_time = transform_deprecode(xf)
        llr = demap_llr(x_time, n0_eff, self.tx.ulsch.Qm)
        B = llr.shape[0]
        flat = llr.reshape(B, -1, self.tx.ulsch.Qm)
        inv = np.empty_like(self.pm.interleave)
        inv[self.pm.interleave] = np.arange(len(self.pm.interleave),
                                            dtype=np.int32)
        llr = flat[:, jnp.asarray(inv)].reshape(B, -1)
        llr = unscramble_llrs(llr, self.tx.scr_seq)
        tb, ok, _ = self.codec.decode(llr)
        srs = None
        if cfg.srs is not None:
            last = self.fp.symbols_per_subframe - 1
            srs = srs_estimate(rgrid[:, last], cfg.srs)
        return tb, ok, srs

    def receive_pucch(self, waveform, n0):
        """Format 1a/1b detection -> (z [B] decision variable, energy)."""
        cfg, fp = self.tx.cfg, self.fp
        t = remove_7_5_khz(waveform, fp)
        rgrid = ofdm.ofdm_demodulate(t, fp)
        z_tot = None
        for slot in (0, 1):
            ns = 2 * cfg.subframe + slot
            sc = self.tx._pucch_sc[slot]
            bins = jnp.asarray(fp.sc_to_bin(sc))
            base = slot * fp.symbols_per_slot
            rx_data = jnp.stack([rgrid[:, base + l, bins]
                                 for l in DATA_SYMS_F1], axis=1)
            rx_rs = jnp.stack([rgrid[:, base + l, bins]
                               for l in RS_SYMS_F1], axis=1)
            z, e = pucch1_detect(rx_data, rx_rs, cfg.n_id_cell, ns,
                                 cfg.n_cs1, cfg.n_oc)
            z_tot = z if z_tot is None else z_tot + z
        return z_tot


@dataclass
class HarqFeedbackState:
    """Per-UE uplink HARQ bookkeeping (process_HARQ_feedback + the drop
    rule of phy_procedures_lte_eNb.c:1415)."""
    max_rounds: int = 4
    max_consecutive_errors: int = 20
    round: int = 0
    consecutive_errors: int = 0
    dropped: bool = False
    n_ack: int = 0
    n_nack: int = 0

    def feedback(self, crc_ok: bool) -> dict:
        """One TTI's decode outcome -> action for the scheduler."""
        if self.dropped:
            return dict(action="dropped", rv=0)
        if crc_ok:
            self.n_ack += 1
            self.consecutive_errors = 0
            self.round = 0
            return dict(action="new_tx", rv=0)
        self.n_nack += 1
        self.consecutive_errors += 1
        if self.consecutive_errors >= self.max_consecutive_errors:
            self.dropped = True              # UE lost: trigger RA again
            return dict(action="dropped", rv=0)
        self.round += 1
        if self.round >= self.max_rounds:
            self.round = 0                   # TB lost: hand to RLC ARQ
            return dict(action="new_tx", rv=0)
        rv = (0, 2, 3, 1)[self.round & 3]    # 36.213 rv cycle
        return dict(action="retx", rv=rv)
