"""UE per-subframe RX procedures: the full downlink receiver.

Reference parity: openair1/SCHED/phy_procedures_lte_ue.c:2398
(phy_procedures_UE_RX — slot FEP, measurements, PBCH on subframe 0,
PCFICH -> CFI, PDCCH blind DCI search, rx_pdsch + dlsch_decoding, PHICH,
ACK/NACK generation).

One function from the received [B, nsym, n_fft] grid to
decoded TB + control decisions, entirely jit-compatible; the DCI gating
(a missed DCI voids the PDSCH attempt — dlsim errs[0] semantics,
dlsim.c:3011-3023) is a boolean mask, not control flow.
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..ops.gold import (gold_sequence, pdsch_cinit, unscramble_llrs)
from ..ops.llr import demap_llr
from ..ops.equalize_llr import mrc_llr
from ..phy.pdsch import DlschConfig, DlschCodec
from ..phy.resource_grid import make_grid_map
from ..phy.control_region import make_control_region_map
from ..phy.channel_est import make_wiener_stack, estimate_channel
from ..phy.measurements import measure
from ..phy.pdcch import (cfi_decode, dci_format1a_size,
                         pdcch_scramble_seq, search_space_candidates,
                         common_search_candidates, ue_search_candidates,
                         dci_blind_decode, BITS_PER_CCE)
from ..phy.dci_formats import (dci_format1_size, dci_format2_size,
                               dci_format2a_size, dci_format1b_size,
                               dci_format1d_size)
from ..phy.phich import phich_group_rx, phich_reg_positions
from .enb_tx import CellConfig


# 36.213 Table 7.1-5: the TM-specific DCI format searched in the
# UE-specific space (format 1A is always searched as well)
def tm_ue_format(tm: int, n_rb: int, n_tx: int = 2):
    """-> (format name, payload size) of the transmission mode's
    UE-specific-space DCI (dci.c:2788's per-TM size hypotheses)."""
    if tm in (1, 2, 7):
        return "1", dci_format1_size(n_rb)
    if tm == 3:
        return "2a", dci_format2a_size(n_rb, n_tx)
    if tm == 4:
        return "2", dci_format2_size(n_rb, n_tx)
    if tm == 5:
        return "1d", dci_format1d_size(n_rb, n_tx)
    if tm == 6:
        return "1b", dci_format1b_size(n_rb, n_tx)
    raise ValueError(f"TM{tm}")


class UeRx:
    """Full-subframe receiver for one configured UE."""

    def __init__(self, cfg: CellConfig, n_turbo_iter: int = 8,
                 tm: int = 1, n_tx: int = 2):
        self.cfg = cfg
        ns = 2 * cfg.subframe
        self.codec = DlschCodec(DlschConfig(
            mcs=cfg.mcs, n_rb=cfg.n_prb, n_pdcch_symbols=cfg.n_pdcch,
            n_turbo_iter=n_turbo_iter))
        self.gm = make_grid_map(cfg.n_rb, cfg.n_pdcch, cfg.n_id_cell,
                                cfg.subframe)
        self.am = make_grid_map(cfg.n_rb, cfg.n_pdcch, cfg.n_id_cell,
                                cfg.subframe,
                                rb_alloc=(cfg.rb_start, cfg.n_prb))
        assert self.am.n_data_re * self.codec.cfg.Qm == self.codec.cfg.G
        self.crm = make_control_region_map(
            cfg.n_rb, cfg.n_pdcch, cfg.n_id_cell,
            n_phich_groups=cfg.n_phich_groups)
        self.scr_seq = gold_sequence(
            pdsch_cinit(cfg.rnti, 0, ns, cfg.n_id_cell), self.codec.cfg.G)
        self.pdcch_scr = pdcch_scramble_seq(cfg.n_id_cell, ns,
                                            self.crm.n_cce * BITS_PER_CCE)
        # Multi-size blind search (dci_decoding_procedure, dci.c:2788):
        # the 0/1A size runs over the COMMON + UE-specific spaces; the
        # TM-specific format's size over the UE-specific space only.
        n_cce = self.crm.n_cce
        common = common_search_candidates(n_cce)
        uespec = ue_search_candidates(n_cce, cfg.rnti, cfg.subframe)
        both = common + [c for c in uespec if c not in common]
        size_1a = dci_format1a_size(cfg.n_rb, tdd=cfg.tdd)
        self.size_hyps = [("1a", size_1a, both)]
        fmt, size_tm = tm_ue_format(tm, cfg.n_rb, n_tx)
        if size_tm != size_1a:
            self.size_hyps.append((fmt, size_tm, uespec))
        self.tm = tm
        # back-compat attrs (fullsim drives the 1A hypothesis directly)
        self.candidates = both
        self.dci_len = size_1a
        self.phich_sc = phich_reg_positions(cfg.n_rb, cfg.n_id_cell,
                                            cfg.n_phich_groups)
        fp = self.gm.fp
        self.phich_bin = fp.sc_to_bin(self.phich_sc.reshape(-1)).reshape(
            self.phich_sc.shape)

    def make_wiener(self, n0: float) -> np.ndarray:
        return make_wiener_stack(self.gm, float(n0) / 4.0)

    def receive(self, rgrid, n0, wiener):
        """rgrid [B, nsym, n_fft] -> dict with cfi_ok, dci_ok, dci_payload,
        tb, tb_ok, ack (=tb_ok gated on dci), phich_z, measurements."""
        cfg = self.cfg
        B = rgrid.shape[0]
        H = estimate_channel(rgrid, self.gm, wiener, time_avg=True)
        meas = measure(rgrid, self.gm, H_hat=H)

        def eq_llr(sym_idx, bin_idx, sc_idx):
            # fused compensation+equalize+demap (ops/equalize_llr)
            y = rgrid[:, jnp.asarray(sym_idx), jnp.asarray(bin_idx)]
            h = H[:, jnp.asarray(sym_idx), jnp.asarray(sc_idx)]
            return mrc_llr(y[..., None], h[..., None], n0,
                           2).reshape(B, -1)

        # ---- PCFICH -> CFI ----------------------------------------------
        crm = self.crm
        ns = 2 * cfg.subframe
        cinit = ((ns // 2 + 1) * (2 * cfg.n_id_cell + 1) << 9) + cfg.n_id_cell
        sgn = jnp.asarray(
            1.0 - 2.0 * gold_sequence(cinit, 32).astype(np.float32))
        cfi_hat, _ = cfi_decode(
            eq_llr(crm.pcfich_sym, crm.pcfich_bin, crm.pcfich_sc) * sgn)

        # ---- PDCCH blind DCI search (all size hypotheses) ----------------
        sgn_p = jnp.asarray(1.0 - 2.0 * self.pdcch_scr.astype(np.float32))
        llr_pdcch = eq_llr(crm.pdcch_sym, crm.pdcch_bin, crm.pdcch_sc)
        dcis = {}
        for fmt, size, cands in self.size_hyps:
            f, p, _ = dci_blind_decode(llr_pdcch * sgn_p, size, cfg.rnti,
                                       cands)
            dcis[fmt] = (f, p)
        found, payload = dcis["1a"]

        # ---- PHICH (group 0, sequence 0) ---------------------------------
        yp = rgrid[:, 0, jnp.asarray(self.phich_bin[0])]
        hp = H[:, 0, jnp.asarray(self.phich_sc[0])]
        yeq = yp * jnp.conj(hp) / (jnp.abs(hp) ** 2 + n0)
        phich_z = phich_group_rx(yeq, cfg.n_id_cell, ns)[:, 0]
        phich_ack = (phich_z.real > 0)

        # ---- PDSCH -------------------------------------------------------
        y = rgrid[:, jnp.asarray(self.am.data_sym),
                  jnp.asarray(self.am.data_bin)]
        h = H[:, jnp.asarray(self.am.data_sym), jnp.asarray(self.am.data_sc)]
        llr = mrc_llr(y[..., None], h[..., None], n0,
                      self.codec.cfg.Qm).reshape(B, -1)
        llr = unscramble_llrs(llr, self.scr_seq)
        tb, tb_ok, _ = self.codec.decode(llr)

        return dict(cfi_hat=cfi_hat, dci_found=found, dci_payload=payload,
                    dci=dcis, tb=tb, tb_ok=tb_ok, ack=found & tb_ok,
                    phich_ack=phich_ack, meas=meas)
