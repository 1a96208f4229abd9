"""UE per-subframe TX procedures: the full uplink subframe builder.

Reference parity: openair1/SCHED/phy_procedures_lte_ue.c:649
(phy_procedures_UE_TX — SRS/PUCCH/PUSCH selection per subframe,
ulsch_encoding + ulsch_modulation :931-996, PRACH trigger :1357-1460,
open-loop power control).

One [B, nsym, n_fft] grid per subframe; PUSCH/PUCCH/SRS are
scatters from host-precomputed maps; power control scales amplitudes per
batch element.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import jax.numpy as jnp

from ..config import FrameParms
from ..phy.pdsch import DlschCodec
from ..phy.pusch import UlschConfig
from ..phy.scfdma import (make_pusch_map, pusch_fill_grid_x, pusch_fill_grid,
                          apply_7_5_khz)
from ..phy.ulref import pusch_dmrs
from ..phy.srs import SrsConfig, srs_bins, srs_sequence
from ..phy.pucch import pucch1_slot_symbols, DATA_SYMS_F1, RS_SYMS_F1
from ..phy import ofdm
from ..ops.gold import gold_sequence, pusch_cinit, scramble_bits
from ..ops.llr import map_symbols


@dataclass(frozen=True)
class UeUlConfig:
    n_rb: int = 25
    mcs: int = 10
    n_rb_alloc: int = 20
    rb_offset: int = 0
    rnti: int = 0x1234
    n_id_cell: int = 0
    subframe: int = 0
    srs: SrsConfig | None = None        # SRS on the last SC-FDMA symbol
    pucch_rb: int = 24                  # PUCCH resource RB (band edge)
    n_cs1: int = 0
    n_oc: int = 0
    n_turbo_iter: int = 6


class UeTx:
    """Builds complete UL subframes: PUSCH(+DMRS) or PUCCH, optional SRS."""

    def __init__(self, cfg: UeUlConfig):
        self.cfg = cfg
        self.fp = FrameParms(n_rb=cfg.n_rb, n_id_cell=cfg.n_id_cell)
        has_srs = cfg.srs is not None
        self.pm = make_pusch_map(cfg.n_rb, cfg.n_rb_alloc, cfg.rb_offset,
                                 srs=has_srs)
        g = len(self.pm.data_syms) * self.pm.m_sc * \
            UlschConfig(mcs=cfg.mcs, n_rb_alloc=cfg.n_rb_alloc).Qm
        self.ulsch = UlschConfig(mcs=cfg.mcs, n_rb_alloc=cfg.n_rb_alloc,
                                 n_turbo_iter=cfg.n_turbo_iter,
                                 g_override=g if has_srs else None)
        self.codec = DlschCodec(self.ulsch)
        self.dmrs = pusch_dmrs(self.pm.m_sc)
        cinit = pusch_cinit(cfg.rnti, 2 * cfg.subframe, cfg.n_id_cell)
        self.scr_seq = gold_sequence(cinit, self.ulsch.G)
        if cfg.srs is not None:
            self._srs_bins = srs_bins(cfg.srs)
            self._srs_seq = srs_sequence(cfg.srs)
        # PUCCH geometry: RB at cfg.pucch_rb in slot 0, mirrored in slot 1
        self._pucch_sc = [np.arange(12) + 12 * cfg.pucch_rb,
                          np.arange(12) + 12 * (cfg.n_rb - 1 - cfg.pucch_rb)]

    # ------------------------------------------------------------- PUSCH --
    def pusch_subframe(self, tb_bits, rv: int = 0):
        """tb_bits [B, TBS] -> time waveform [B, samples]. When an SRS is
        configured, the last SC-FDMA symbol carries it and the PUSCH rate
        matching is shortened accordingly (map built with srs=True)."""
        e = self.codec.encode(tb_bits, rv)
        e = scramble_bits(e, self.scr_seq)
        sym = map_symbols(e, self.ulsch.Qm).astype(jnp.complex64)
        grid = pusch_fill_grid(sym, self.pm, self.dmrs)
        if self.cfg.srs is not None:
            last = self.fp.symbols_per_subframe - 1
            grid = grid.at[:, last, jnp.asarray(self._srs_bins)].set(
                jnp.asarray(self._srs_seq))
        t = ofdm.ofdm_modulate(grid, self.fp)
        return apply_7_5_khz(t, self.fp)

    # ------------------------------------------------------------- PUCCH --
    def pucch_subframe(self, d):
        """Format 1a/1b subframe: d [B] complex payload (+-1 BPSK for 1a,
        QPSK for 1b, 1.0 for SR). Returns waveform [B, samples]."""
        cfg, fp = self.cfg, self.fp
        B = d.shape[0]
        grid = jnp.zeros((B, fp.symbols_per_subframe, fp.n_fft),
                         jnp.complex64)
        for slot in (0, 1):
            ns = 2 * cfg.subframe + slot
            data_ref, rs_ref = pucch1_slot_symbols(cfg.n_id_cell, ns,
                                                   cfg.n_cs1, cfg.n_oc, 1.0)
            sc = self._pucch_sc[slot]
            bins = jnp.asarray(fp.sc_to_bin(sc))
            base = slot * fp.symbols_per_slot
            for i, l in enumerate(DATA_SYMS_F1):
                grid = grid.at[:, base + l, bins].set(
                    d[:, None] * jnp.asarray(data_ref[i]))
            for i, l in enumerate(RS_SYMS_F1):
                grid = grid.at[:, base + l, bins].set(
                    jnp.asarray(rs_ref[i]))
        t = ofdm.ofdm_modulate(grid, fp)
        return apply_7_5_khz(t, fp)
