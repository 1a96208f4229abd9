"""eNB per-subframe TX procedures: the full downlink subframe builder.

Reference parity: openair1/SCHED/phy_procedures_lte_eNb.c:1372
(phy_procedures_eNB_TX — per subframe: PSS/SSS/pilots/PBCH, DCIs via
generate_dci_top, PDSCH encode->scramble->modulate, PHICH; then OFDM mod).

Every channel's RE coordinates and static symbol values are
host-precomputed once per cell config; building a subframe for a batch of
trials is a handful of scatters into the [B, 14, n_fft] grid followed by
one batched IFFT — there is no per-RE control flow on device.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import jax.numpy as jnp

from ..config import FrameParms
from ..ops.gold import gold_sequence
from ..phy.resource_grid import make_grid_map, fill_grid
from ..phy.control_region import make_control_region_map
from ..phy.pdcch import (cfi_encode, dci_format1a_size, pack_dci_format1a,
                         dci_encode, pdcch_scramble_seq, BITS_PER_CCE)
from ..phy.phich import phich_group_tx, phich_reg_positions, phich_scramble, _W
from ..phy.pbch import make_pbch_map, pack_mib, pbch_frame_symbols
from ..phy.sync import pss_sequence, sss_sequence, center62_bins
from ..phy import ofdm


@dataclass(frozen=True)
class CellConfig:
    """Static cell + scheduling configuration for the full-chain procedures."""
    n_rb: int = 25
    n_id_cell: int = 0
    n_pdcch: int = 3
    n_phich_groups: int = 1
    rnti: int = 0x1234
    # the one scheduled UE's PDSCH allocation (DCI format 1A, type-2 VRB)
    rb_start: int = 0
    n_prb: int = 25
    mcs: int = 4
    dci_L: int = 4
    dci_cce_offset: int = 0
    subframe: int = 7
    tdd: bool = False        # TDD cell: 1A carries 4-bit HARQ + 2-bit DAI


class EnbTx:
    """Builds complete DL subframes for one cell (batched over trials)."""

    def __init__(self, cfg: CellConfig):
        self.cfg = cfg
        self.fp = FrameParms(n_rb=cfg.n_rb, n_id_cell=cfg.n_id_cell)
        ns = 2 * cfg.subframe
        self.crm = make_control_region_map(
            cfg.n_rb, cfg.n_pdcch, cfg.n_id_cell,
            n_phich_groups=cfg.n_phich_groups)
        # full-band map (pilots) and the PDSCH allocation map (data REs)
        self.gm = make_grid_map(cfg.n_rb, cfg.n_pdcch, cfg.n_id_cell,
                                cfg.subframe)
        self.am = make_grid_map(cfg.n_rb, cfg.n_pdcch, cfg.n_id_cell,
                                cfg.subframe,
                                rb_alloc=(cfg.rb_start, cfg.n_prb))

        # ---- PCFICH (36.211 §6.7) --------------------------------------
        cinit = ((ns // 2 + 1) * (2 * cfg.n_id_cell + 1) << 9) + cfg.n_id_cell
        b = cfi_encode(cfg.n_pdcch) ^ gold_sequence(cinit, 32).astype(np.int8)
        self.pcfich_syms = (((1 - 2 * b[0::2]) + 1j * (1 - 2 * b[1::2]))
                            / np.sqrt(2)).astype(np.complex64)

        # ---- PDCCH: one DCI format 1A for the scheduled UE --------------
        n_cce = self.crm.n_cce
        assert cfg.dci_cce_offset + cfg.dci_L <= n_cce
        self.pdcch_scr = pdcch_scramble_seq(cfg.n_id_cell, ns,
                                            n_cce * BITS_PER_CCE)
        self.set_dci_payload(pack_dci_format1a(
            cfg.n_rb, rb_start=cfg.rb_start, n_prb=cfg.n_prb, mcs=cfg.mcs,
            harq_pid=0, ndi=1, rv=0, tdd=cfg.tdd))
        assert len(self.dci_payload) == dci_format1a_size(cfg.n_rb,
                                                          tdd=cfg.tdd)

        # ---- PHICH group 0 geometry -------------------------------------
        self._init_phich(ns)

    def set_dci_payload(self, payload: np.ndarray) -> None:
        """(Re)encode the PDCCH with an arbitrary DCI payload (any format
        of the 1A/0 size class, or other sizes that fit dci_L CCEs) —
        lets sims carry UL grants (format 0) or MIMO grants through the
        same control region."""
        cfg = self.cfg
        self.dci_payload = np.asarray(payload, np.int8)
        self.set_dcis([(self.dci_payload, cfg.rnti, cfg.dci_L,
                        cfg.dci_cce_offset)])

    def set_dcis(self, dcis) -> None:
        """Encode multiple DCIs into the control region; `dcis` is a list of
        (payload_bits, rnti, L, cce_offset). Mirrors generate_dci_top
        (dci.c:2084-2096: per-DCI CC encode + CRC16 masked by RNTI, NIL
        CCEs at zero power)."""
        n_cce = self.crm.n_cce
        full = np.zeros(n_cce * BITS_PER_CCE, np.int8)
        used = np.zeros(n_cce * BITS_PER_CCE // 2, bool)
        for payload, rnti, L, cce_offset in dcis:
            assert cce_offset + L <= n_cce, (cce_offset, L, n_cce)
            e = dci_encode(np.asarray(payload, np.int8), rnti, L)
            s = cce_offset * BITS_PER_CCE
            assert not used[s // 2:(s + len(e)) // 2].any(), "CCE overlap"
            full[s:s + len(e)] = e ^ self.pdcch_scr[s:s + len(e)]
            used[s // 2:(s + len(e)) // 2] = True
        syms = ((1 - 2 * full[0::2]) + 1j * (1 - 2 * full[1::2])) / np.sqrt(2)
        self.pdcch_syms = np.where(used, syms, 0).astype(np.complex64)

    def _init_phich(self, ns: int) -> None:
        cfg = self.cfg
        self.phich_sc = phich_reg_positions(cfg.n_rb, cfg.n_id_cell,
                                            cfg.n_phich_groups)   # [G, 12]
        self.phich_bin = self.fp.sc_to_bin(self.phich_sc.reshape(-1)).reshape(
            self.phich_sc.shape)
        # spreading constants for on-device TX of a dynamic ACK bit
        c = phich_scramble(cfg.n_id_cell, ns)
        self._phich_seq0 = jnp.asarray(
            (np.tile(_W[0], 3) * c / np.sqrt(2)).astype(np.complex64))

    # -------------------------------------------------------------- build --
    def data_subframe(self, pdsch_syms, ack_bits=None):
        """pdsch_syms [B, n_alloc_re] complex, ack_bits [B] in {0,1} or None
        -> grid [B, nsym, n_fft] with pilots + PCFICH + PHICH + PDCCH +
        PDSCH."""
        B = pdsch_syms.shape[0]
        grid = fill_grid(jnp.zeros((B, self.gm.n_data_re), jnp.complex64),
                         self.gm, with_pilots=True)
        grid = grid.at[:, jnp.asarray(self.am.data_sym),
                       jnp.asarray(self.am.data_bin)].set(pdsch_syms)
        crm = self.crm
        grid = grid.at[:, jnp.asarray(crm.pcfich_sym),
                       jnp.asarray(crm.pcfich_bin)].set(
            jnp.asarray(self.pcfich_syms))
        grid = grid.at[:, jnp.asarray(crm.pdcch_sym),
                       jnp.asarray(crm.pdcch_bin)].set(
            jnp.asarray(self.pdcch_syms))
        if ack_bits is not None:
            hi = (2.0 * ack_bits.astype(jnp.float32) - 1.0)   # ACK=+1 NACK=-1
            vals = hi[:, None] * self._phich_seq0[None, :]    # [B, 12]
            grid = grid.at[:, 0, jnp.asarray(self.phich_bin[0])].set(vals)
        return grid

    def data_waveform(self, pdsch_syms, ack_bits=None):
        return ofdm.ofdm_modulate(self.data_subframe(pdsch_syms, ack_bits),
                                  self.fp)

    # ---------------------------------------------------- subframe 0 (sync) --
    @functools.lru_cache(maxsize=4)
    def sync_subframe_host(self, sfn: int = 0) -> np.ndarray:
        """Host-built subframe-0 grid [nsym, n_fft]: PSS (sym 6), SSS (sym
        5), PBCH quarter (slot-1 syms 0..3) + pilots. One per SFN phase."""
        cfg, fp = self.cfg, self.fp
        gm0 = make_grid_map(cfg.n_rb, cfg.n_pdcch, cfg.n_id_cell, subframe=0)
        grid = np.zeros((fp.symbols_per_subframe, fp.n_fft), np.complex64)
        grid[gm0.pilot_sym, gm0.pilot_bin] = gm0.pilot_val
        bins = center62_bins(fp)
        nid1, nid2 = cfg.n_id_cell // 3, cfg.n_id_cell % 3
        grid[5, bins] = sss_sequence(nid1, nid2, False)
        grid[6, bins] = pss_sequence(nid2)
        pm = make_pbch_map(cfg.n_rb, cfg.n_id_cell)
        mib = pack_mib(cfg.n_rb, sfn)
        grid[pm.sym, pm.bins] = pbch_frame_symbols(mib, cfg.n_id_cell,
                                                   sfn % 4)
        return grid
