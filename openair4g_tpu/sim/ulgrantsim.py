"""PDCCH-granted PUSCH loop: DCI format 0 UL grant -> UE blind decode ->
granted PUSCH transmission -> eNB decode -> HARQ rv cycling.

Reference parity: the closed scheduling loop of the softmodem —
eNB TX sends the format-0 grant on the PDCCH
(generate_dci_top, openair1/PHY/LTE_TRANSPORT/dci.c), the UE finds it by
blind search (dci_decoding_procedure0 :2547) and derives its PUSCH
parameters (generate_ue_ulsch_params_from_dci, dci_tools.c), transmits
in subframe n+4 (phy_procedures_UE_TX, phy_procedures_lte_ue.c:931-996),
and the eNB decodes + runs HARQ feedback
(phy_procedures_eNB_RX :3196, process_HARQ_feedback :2658). The
reference's ulsim uses a static grant; this harness closes the loop the
softmodem way. A missed/corrupted grant means the UE stays silent that
TTI — counted like dlsim's DCI-error column (dlsim.c:3011-3023).

The grant that the eNB issues is static per config, so all
RE maps stay shape-static under jit; the UE's *acceptance* of the grant
(blind-decode success + payload match) is a per-trial boolean that gates
its transmit waveform — the data-dependent part is a mask, not a shape.
HARQ rounds are an unrolled scan with persistent soft buffers; the
ACK/NACK routing between rounds is ideal here (the noisy PHICH path is
exercised in fullsim).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import jax
import jax.numpy as jnp

from ..utils.rng import host_keys
from ..sched.enb_tx import CellConfig, EnbTx
from ..sched.ue_tx import UeUlConfig, UeTx
from ..sched.enb_rx import EnbRx
from ..phy import ofdm
from ..phy.channel_est import make_wiener_stack, estimate_channel
from ..phy.pdcch import dci_blind_decode, search_space_candidates
from ..phy.dci_formats import (pack_dci_format0, unpack_dci_format0,
                               dci_format0_size)
from ..phy.pusch import make_ul_wiener
from ..ops.llr import demap_llr

RV_SEQ = (0, 2, 3, 1)     # 36.321 rv cycling for UL HARQ retransmissions


@dataclass(frozen=True)
class UlGrantConfig:
    n_rb: int = 25
    mcs_ul: int = 10
    rb_offset: int = 2
    n_prb: int = 20
    rnti: int = 0x1234
    n_id_cell: int = 0
    n_pdcch: int = 3
    dci_L: int = 4
    dl_subframe: int = 0      # grant TTI; PUSCH goes out in n+4
    n_harq_rounds: int = 4
    n_turbo_iter: int = 6
    batch: int = 64


class UlGrantSim:
    """eNB grant -> UE PUSCH -> eNB decode, batched over trials."""

    def __init__(self, cfg: UlGrantConfig):
        self.cfg = cfg
        # --- eNB DL control subframe carrying the format-0 grant --------
        self.cell = CellConfig(
            n_rb=cfg.n_rb, n_id_cell=cfg.n_id_cell, n_pdcch=cfg.n_pdcch,
            rnti=cfg.rnti, rb_start=cfg.rb_offset, n_prb=cfg.n_prb,
            mcs=cfg.mcs_ul, dci_L=cfg.dci_L, subframe=cfg.dl_subframe)
        self.enb_tx = EnbTx(self.cell)
        self.grant_payload = pack_dci_format0(
            cfg.n_rb, rb_start=cfg.rb_offset, n_prb=cfg.n_prb,
            mcs=cfg.mcs_ul, ndi=1)
        self.enb_tx.set_dci_payload(self.grant_payload)
        self.fp = self.enb_tx.fp

        # --- UE side: control receiver + granted PUSCH builder ----------
        self.gm = self.enb_tx.gm
        self.crm = self.enb_tx.crm
        self.candidates = search_space_candidates(self.crm.n_cce)
        self.dci_len = dci_format0_size(cfg.n_rb)
        assert len(self.grant_payload) == self.dci_len
        grant = unpack_dci_format0(self.grant_payload, cfg.n_rb)
        assert grant["is_format0"]
        # the UE configures its TX from the PARSED grant fields — the
        # payload->parameter path is the same one the jit step validates
        self.ue_tx = UeTx(UeUlConfig(
            n_rb=cfg.n_rb, mcs=grant["mcs"], n_rb_alloc=grant["n_prb"],
            rb_offset=grant["rb_start"], rnti=cfg.rnti,
            n_id_cell=cfg.n_id_cell,
            subframe=(cfg.dl_subframe + 4) % 10,
            n_turbo_iter=cfg.n_turbo_iter))
        self.enb_rx = EnbRx(self.ue_tx)
        self.codec = self.ue_tx.codec
        self._expected = jnp.asarray(self.grant_payload.astype(np.int32))
        self._step = jax.jit(self._trial_step)

    # ------------------------------------------------------------- step --
    def _ue_decode_grant(self, rgrid, n0, wiener):
        """Blind DCI search on the DL control region -> (grant_ok [B])."""
        B = rgrid.shape[0]
        H = estimate_channel(rgrid, self.gm, wiener, time_avg=True)
        crm = self.crm
        y = rgrid[:, jnp.asarray(crm.pdcch_sym), jnp.asarray(crm.pdcch_bin)]
        h = H[:, jnp.asarray(crm.pdcch_sym), jnp.asarray(crm.pdcch_sc)]
        yeq = y * jnp.conj(h) / (jnp.abs(h) ** 2 + n0)
        llr = demap_llr(yeq, n0 / (jnp.abs(h) ** 2 + 1e-9), 2).reshape(B, -1)
        sgn = jnp.asarray(
            1.0 - 2.0 * self.enb_tx.pdcch_scr.astype(np.float32))
        found, payload, _ = dci_blind_decode(
            llr * sgn, self.dci_len, self.cfg.rnti, self.candidates)
        match = jnp.all(payload.astype(jnp.int32) ==
                        self._expected[None, :], axis=-1)
        # flag bit 0 = "this is format 0" — a 1A-flagged payload is not
        # an UL grant and must be ignored by the UE
        is_f0 = payload[:, 0] == 0
        return found & match & is_f0

    def _trial_step(self, keys, n0_dl, n0_ul, wiener_dl, wiener_ul):
        cfg = self.cfg
        B = keys.shape[0]
        splits = jax.vmap(
            lambda k: jax.random.split(k, 3 + 2 * cfg.n_harq_rounds))(keys)

        # ---- TTI n: DL control subframe over AWGN -----------------------
        zeros = jnp.zeros((B, self.enb_tx.am.n_data_re), jnp.complex64)
        t_dl = self.enb_tx.data_waveform(zeros)
        nr = jax.vmap(lambda k: jax.random.normal(
            k, t_dl.shape[1:] + (2,)))(splits[:, 0])
        rx_dl = t_dl + jnp.sqrt(n0_dl / 2) * (nr[..., 0] + 1j * nr[..., 1])
        rgrid = ofdm.ofdm_demodulate(rx_dl, self.fp)
        grant_ok = self._ue_decode_grant(rgrid, n0_dl, wiener_dl)

        # ---- TTI n+4..: granted PUSCH with HARQ rv cycling --------------
        tb = jax.vmap(lambda k: jax.random.bernoulli(
            k, 0.5, (self.codec.cfg.tbs,)))(splits[:, 1]).astype(jnp.int32)
        mask = grant_ok.astype(jnp.complex64)[:, None]
        w_soft = None
        ok_any = jnp.zeros(B, bool)
        reached = jnp.ones(B, bool)
        errs, reach_counts = [], []
        for rnd in range(cfg.n_harq_rounds):
            rv = RV_SEQ[rnd % 4]
            t_ul = self.ue_tx.pusch_subframe(tb, rv=rv) * mask
            nr = jax.vmap(lambda k: jax.random.normal(
                k, t_ul.shape[1:] + (2,)))(splits[:, 3 + 2 * rnd])
            rx_ul = t_ul + jnp.sqrt(n0_ul / 2) * (nr[..., 0] +
                                                  1j * nr[..., 1])
            tb_hat, ok, w_soft = self._enb_decode(rx_ul, n0_ul, wiener_ul,
                                                  w_soft, rv)
            ok = ok & grant_ok & jnp.all(tb_hat[:, :self.codec.cfg.tbs]
                                         == tb, axis=-1)
            ok_now = ok_any | ok
            err_r = reached & ~ok_now
            errs.append(err_r.sum())
            reach_counts.append(reached.sum())
            reached = err_r
            ok_any = ok_now
        return (~grant_ok).sum(), jnp.stack(errs), jnp.stack(reach_counts)

    def _enb_decode(self, waveform, n0, wiener, w_soft, rv):
        """EnbRx.receive_pusch, opened up to thread HARQ soft buffers."""
        from ..phy.pusch import ul_estimate_channel, scfdma_mmse_equalize
        from ..phy.scfdma import (pusch_extract, transform_deprecode,
                                  remove_7_5_khz)
        from ..ops.gold import unscramble_llrs
        t = remove_7_5_khz(waveform, self.fp)
        rgrid = ofdm.ofdm_demodulate(t, self.fp)
        y, dmrs_rx = pusch_extract(rgrid, self.enb_rx.pm)
        H = ul_estimate_channel(dmrs_rx, self.ue_tx.dmrs, self.enb_rx.pm,
                                wiener)
        xf, n0_eff = scfdma_mmse_equalize(y, H, n0)
        x_time = transform_deprecode(xf)
        llr = demap_llr(x_time, n0_eff, self.ue_tx.ulsch.Qm)
        B = llr.shape[0]
        flat = llr.reshape(B, -1, self.ue_tx.ulsch.Qm)
        inv = np.empty_like(self.enb_rx.pm.interleave)
        inv[self.enb_rx.pm.interleave] = np.arange(
            len(self.enb_rx.pm.interleave), dtype=np.int32)
        llr = flat[:, jnp.asarray(inv)].reshape(B, -1)
        llr = unscramble_llrs(llr, self.ue_tx.scr_seq)
        return self.codec.decode(llr, w_soft=w_soft, rv=rv)

    # ------------------------------------------------------------ sweep --
    def run_snr(self, snr_dl: float, snr_ul: float, n_frames: int,
                seed: int = 0):
        n0_dl = jnp.float32(10.0 ** (-snr_dl / 10.0))
        n0_ul = jnp.float32(10.0 ** (-snr_ul / 10.0))
        wiener_dl = jnp.asarray(make_wiener_stack(self.gm,
                                                  float(n0_dl) / 4.0))
        wiener_ul = jnp.asarray(make_ul_wiener(self.enb_rx.pm, float(n0_ul)))
        R = self.cfg.n_harq_rounds
        dci_errs = 0
        errs = np.zeros(R, np.int64)
        reach = np.zeros(R, np.int64)
        for i in range(-(-n_frames // self.cfg.batch)):
            keys = jnp.asarray(host_keys(seed, self.cfg.batch, stream=i))
            d, e, t = self._step(keys, n0_dl, n0_ul, wiener_dl, wiener_ul)
            dci_errs += int(d)
            errs += np.asarray(e, np.int64)
            reach += np.asarray(t, np.int64)
        return dci_errs, errs, reach

    def sweep(self, snr_dl: float, snrs_ul, n_frames: int, seed: int = 0,
              verbose: bool = True):
        rows = []
        for s in snrs_ul:
            d, errs, reach = self.run_snr(snr_dl, float(s), n_frames, seed)
            bler = errs / np.maximum(reach, 1)
            rows.append(dict(snr_ul=float(s), dci_errs=d, errs=errs.copy(),
                             reached=reach.copy(), bler=bler.copy()))
            if verbose:
                txt = " ".join(f"r{r}:{bler[r]:.3f}({errs[r]}/{reach[r]})"
                               for r in range(len(bler)))
                print(f"UL SNR {s:+6.2f} dB: dci_err {d}  {txt}", flush=True)
            if errs[-1] == 0:
                break
        return rows
