"""Full eNB-TX -> UE-RX chain simulator (BASELINE config 4: "20 MHz full
chain w/ HARQ").

Reference parity: the combination dlsim exercises per trial once synced —
eNB TX builds the complete subframe (pilots, PCFICH, PHICH, PDCCH DCI
format 1A, PDSCH; phy_procedures_eNB_TX, phy_procedures_lte_eNb.c:1372),
the UE runs the complete receiver (CFI decode, blind DCI search, channel
estimation, PDSCH demod + turbo decode, PHICH; phy_procedures_UE_RX,
phy_procedures_lte_ue.c:2398); a missed DCI voids the TB exactly like
dlsim's errs[0] accounting (dlsim.c:3011-3023). Cold start (PSS/SSS/PBCH
from a timing-offset capture) mirrors initial_sync.c:274.

One jitted trial step per HARQ round batched over trials;
HARQ keeps per-block soft buffers across rounds (donated carries).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import jax
import jax.numpy as jnp

from ..config import FrameParms
from ..utils.rng import host_keys
from ..sched.enb_tx import CellConfig, EnbTx
from ..sched.ue_rx import UeRx
from ..phy import ofdm
from ..phy.sync import CellSearch
from ..phy.pbch import make_pbch_map, pbch_blind_decode, unpack_mib
from ..phy.channel_est import make_wiener_stack, estimate_channel
from ..ops.gold import scramble_bits
from ..ops.llr import map_symbols, demap_llr
from ..ops.equalize_llr import mrc_llr
from .channels import ChannelModel, apply_channel_bins


@dataclass(frozen=True)
class FullsimConfig:
    n_rb: int = 100               # 20 MHz
    mcs: int = 4
    rb_start: int = 0
    n_prb: int | None = None      # default: full band
    channel: str = "AWGN"
    n_harq_rounds: int = 4
    n_pdcch: int = 3
    n_id_cell: int = 0
    rnti: int = 0x1234
    subframe: int = 7
    n_turbo_iter: int = 8
    batch: int = 32


class FullChainSim:
    def __init__(self, cfg: FullsimConfig):
        self.cfg = cfg
        n_prb = cfg.n_rb if cfg.n_prb is None else cfg.n_prb
        self.cell = CellConfig(
            n_rb=cfg.n_rb, n_id_cell=cfg.n_id_cell, n_pdcch=cfg.n_pdcch,
            rnti=cfg.rnti, rb_start=cfg.rb_start, n_prb=n_prb, mcs=cfg.mcs,
            subframe=cfg.subframe)
        self.enb = EnbTx(self.cell)
        self.ue = UeRx(self.cell, n_turbo_iter=cfg.n_turbo_iter)
        self.fp = self.enb.fp
        self.chan = ChannelModel(name=cfg.channel, fp=self.fp)
        self.codec = self.ue.codec
        self.scr_seq = self.ue.scr_seq
        self._step = jax.jit(self._trial_step)

    # ----------------------------------------------------------- cold start --
    def cold_start(self, snr_db: float, batch: int = 16, seed: int = 0):
        """PSS/SSS sync + PBCH MIB decode from a noisy capture with random
        timing offset. Returns dict with detection rates (initial_sync)."""
        fp = self.fp
        grid0 = self.enb.sync_subframe_host(sfn=0)
        wave = ofdm.ofdm_modulate_host(grid0[None], fp)[0]
        search = CellSearch(fp)
        L = search.capture_len
        max_off = L - fp.samples_per_tti - fp.n_fft
        n0 = 10.0 ** (-snr_db / 10.0)
        rng = np.random.default_rng(seed)
        offs = rng.integers(0, max_off, batch)
        caps = np.zeros((batch, L), np.complex64)
        for b in range(batch):
            caps[b, offs[b]:offs[b] + len(wave)] = wave
        caps += (rng.standard_normal((batch, L))
                 + 1j * rng.standard_normal((batch, L))).astype(np.complex64) \
            * np.sqrt(n0 / 2)
        res = search.search(jnp.asarray(caps))
        pss_t0 = (fp.cp0 + fp.n_fft) + 5 * (fp.cp + fp.n_fft) + fp.cp
        nid_ok = np.asarray((res["nid2"] == self.cell.n_id_cell % 3)
                            & (res["nid1"] == self.cell.n_id_cell // 3))
        pos_ok = np.abs(np.asarray(res["pss_pos"]) - (offs + pss_t0)) <= 2

        # PBCH from the frame-aligned grid (perfectly re-centered captures
        # for the MIB stage; timing recovery is scored above)
        rgrid = ofdm.ofdm_demodulate(
            jnp.asarray(np.stack([caps[b, offs[b]:offs[b]
                                       + fp.samples_per_tti]
                                  for b in range(batch)])), fp)
        from ..phy.resource_grid import make_grid_map
        gm0 = make_grid_map(self.cell.n_rb, 1, self.cell.n_id_cell,
                            subframe=0)   # subframe-0 pilot values
        wiener = jnp.asarray(make_wiener_stack(gm0, n0 / 4.0))
        H = estimate_channel(rgrid, gm0, wiener, time_avg=True)
        pm = make_pbch_map(self.cell.n_rb, self.cell.n_id_cell)
        y = rgrid[:, jnp.asarray(pm.sym), jnp.asarray(pm.bins)]
        h = H[:, jnp.asarray(pm.sym), jnp.asarray(pm.sc)]
        g = jnp.maximum(jnp.abs(h) ** 2, 1e-9)
        llr = demap_llr(y * jnp.conj(h) / g, n0 / g, 2).reshape(batch, -1)
        mib_ok, mib_bits, _, _ = pbch_blind_decode(llr, self.cell.n_id_cell)
        mib = unpack_mib(np.asarray(mib_bits[0]))
        return dict(sync_rate=float(nid_ok.mean()),
                    timing_rate=float(pos_ok.mean()),
                    mib_rate=float(np.asarray(mib_ok).mean()),
                    mib=mib)

    # ------------------------------------------------------------ data step --
    def _trial_step(self, keys, n0, wiener):
        cfg = self.cfg
        codec = self.codec
        B = keys.shape[0]
        Qm = codec.cfg.Qm
        splits = jax.vmap(
            lambda k: jax.random.split(k, 2 + 2 * cfg.n_harq_rounds))(keys)
        tb = jax.vmap(lambda k: jax.random.bernoulli(
            k, 0.5, (codec.cfg.tbs,)))(splits[:, 0]).astype(jnp.int32)
        d_flats = codec.encode_to_d(tb)
        # the PHICH carries a known random ACK bit (uplink HARQ feedback)
        ack_tx = jax.vmap(lambda k: jax.random.bernoulli(k, 0.5, ()))(
            splits[:, 1])

        f_idx = tuple((np.arange(self.fp.n_sc) - 6 * self.fp.n_rb).tolist())
        bins = self.fp.sc_to_bin(np.arange(self.fp.n_sc))

        reached = jnp.ones(B, bool)
        ok_any = jnp.zeros(B, bool)
        w_soft = None
        errs, reach_counts = [], []
        dci_miss = jnp.zeros((), jnp.int32)
        phich_err = jnp.zeros((), jnp.int32)
        for rnd in range(cfg.n_harq_rounds):
            rv = rnd & 3
            e = codec.select_e(d_flats, rv)
            e = scramble_bits(e, self.scr_seq)
            sym = map_symbols(e, Qm).astype(jnp.complex64)
            grid = self.enb.data_subframe(sym, ack_bits=ack_tx)
            taps = self.chan.draw_taps(splits[:, 2 + 2 * rnd], B)
            H = self.chan.freq_response_at(taps, f_idx)     # [B, n_sc]
            grid = apply_channel_bins(grid, H, bins, self.fp.n_fft)
            t = ofdm.ofdm_modulate(grid, self.fp)
            nr = jax.vmap(lambda k: jax.random.normal(
                k, t.shape[1:] + (2,)))(splits[:, 3 + 2 * rnd])
            rx = t + jnp.sqrt(n0 / 2) * (nr[..., 0] + 1j * nr[..., 1])
            rgrid = ofdm.ofdm_demodulate(rx, self.fp)

            out = self._ue_round(rgrid, n0, wiener, w_soft, rv)
            if rnd == 0:
                dci_miss = (~out["dci_found"]).sum()
                phich_err = (out["phich_ack"]
                             != ack_tx.astype(bool)).sum()
            w_soft = out["w_soft"]
            ok = out["dci_found"] & out["tb_ok"]
            ok_now = ok_any | ok
            err_r = reached & ~ok_now
            errs.append(err_r.sum())
            reach_counts.append(reached.sum())
            reached = err_r
            ok_any = ok_now
        return (jnp.stack(errs), jnp.stack(reach_counts), dci_miss,
                phich_err)

    def _ue_round(self, rgrid, n0, wiener, w_soft, rv):
        """UeRx.receive, but HARQ-aware (soft-buffer carry + rv)."""
        ue = self.ue
        B = rgrid.shape[0]
        H = estimate_channel(rgrid, ue.gm, wiener, time_avg=True)

        from ..phy.pdcch import cfi_decode, dci_blind_decode
        from ..ops.gold import gold_sequence, unscramble_llrs

        def eq_llr(sym_idx, bin_idx, sc_idx):
            # fused compensation+equalize+demap (ops/equalize_llr)
            y = rgrid[:, jnp.asarray(sym_idx), jnp.asarray(bin_idx)]
            h = H[:, jnp.asarray(sym_idx), jnp.asarray(sc_idx)]
            return mrc_llr(y[..., None], h[..., None], n0,
                           2).reshape(B, -1)

        crm = ue.crm
        cfg = ue.cfg
        ns = 2 * cfg.subframe
        sgn_p = jnp.asarray(1.0 - 2.0 * ue.pdcch_scr.astype(np.float32))
        llr_pdcch = eq_llr(crm.pdcch_sym, crm.pdcch_bin, crm.pdcch_sc)
        found, payload, _ = dci_blind_decode(
            llr_pdcch * sgn_p, ue.dci_len, cfg.rnti, ue.candidates)
        expected = jnp.asarray(self.enb.dci_payload.astype(np.int32))
        dci_found = found & jnp.all(payload == expected, axis=-1)

        from ..phy.phich import phich_group_rx
        yp = rgrid[:, 0, jnp.asarray(ue.phich_bin[0])]
        hp = H[:, 0, jnp.asarray(ue.phich_sc[0])]
        yeq = yp * jnp.conj(hp) / (jnp.abs(hp) ** 2 + n0)
        phich_ack = phich_group_rx(yeq, cfg.n_id_cell, ns)[:, 0].real > 0

        y = rgrid[:, jnp.asarray(ue.am.data_sym), jnp.asarray(ue.am.data_bin)]
        h = H[:, jnp.asarray(ue.am.data_sym), jnp.asarray(ue.am.data_sc)]
        llr = mrc_llr(y[..., None], h[..., None], n0,
                      self.codec.cfg.Qm).reshape(B, -1)
        llr = unscramble_llrs(llr, self.scr_seq)
        tb, tb_ok, w_new = self.codec.decode(llr, w_soft=w_soft, rv=rv)
        return dict(dci_found=dci_found, tb_ok=tb_ok, w_soft=w_new,
                    phich_ack=phich_ack)

    # --------------------------------------------------------------- driver --
    def run_snr(self, snr_db: float, n_frames: int, seed: int = 0):
        n0 = jnp.float32(10.0 ** (-snr_db / 10.0))
        wiener = jnp.asarray(self.ue.make_wiener(float(n0)))
        R = self.cfg.n_harq_rounds
        errs = np.zeros(R, np.int64)
        reach = np.zeros(R, np.int64)
        self.dci_miss = 0
        self.phich_err = 0
        for i in range(-(-n_frames // self.cfg.batch)):
            keys = jnp.asarray(host_keys(seed, self.cfg.batch, stream=i))
            e, t, dm, pe = self._step(keys, n0, wiener)
            errs += np.asarray(e, np.int64)
            reach += np.asarray(t, np.int64)
            self.dci_miss += int(dm)
            self.phich_err += int(pe)
        return errs, reach

    def sweep(self, snrs, n_frames: int, seed: int = 0, verbose: bool = True,
              early_exit: bool = True):
        rows = []
        for s in snrs:
            errs, reach = self.run_snr(float(s), n_frames, seed)
            bler = errs / np.maximum(reach, 1)
            rows.append((float(s), errs.copy(), reach.copy(), bler.copy()))
            if verbose:
                txt = " ".join(f"r{r}:{bler[r]:.3f}({errs[r]}/{reach[r]})"
                               for r in range(len(bler)))
                print(f"SNR {s:+6.2f} dB: {txt} dci_miss:{self.dci_miss} "
                      f"phich_err:{self.phich_err}", flush=True)
            if early_exit and errs[-1] == 0:
                break
        return rows
