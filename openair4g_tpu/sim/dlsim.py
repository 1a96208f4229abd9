"""dlsim equivalent: eNB TX -> channel -> UE RX PDSCH BLER Monte-Carlo.

Reference parity: openair1/SIMULATION/LTE_PHY/dlsim.c:233 (main loop
structure: SNR sweep x trials, TX chain dlsim.c:2553-2704, noise calibration
:2852, RX chain :2927-3364) and the AWGN BLER corpus
BLER_SIMULATIONS/AWGN/AWGN_results/*.csv.

One jitted trial step runs [batch] complete subframes — encode,
scramble, QAM-map, grid-fill, OFDM, channel, OFDM demod, demap, decode — and
the SNR sweep feeds different noise sigmas to the same compiled program.

Noise calibration (must match the reference, dlsim.c:2852): SNR is defined
per occupied subcarrier. With unitary FFTs and a unit-energy constellation,
Es = 1 per RE and time-domain per-sample noise variance N0 = 10^(-SNR/10)
yields exactly Es/N0 = SNR on every RE.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import jax
import jax.numpy as jnp

from ..config import FrameParms
from ..phy.pdsch import DlschConfig, DlschCodec
from ..phy.resource_grid import make_grid_map, fill_grid, extract_data_res
from ..phy import ofdm
from ..phy.channel_est import (make_wiener_stack, estimate_channel,
                                make_wiener_joint, estimate_channel_joint,
                                joint_err_var)
from ..ops.gold import gold_sequence, pdsch_cinit, scramble_bits, unscramble_llrs
from ..ops.llr import map_symbols, demap_llr
from ..ops.equalize_llr import mrc_llr
from ..utils.rng import host_keys
from ..utils import profiler
from .channels import ChannelModel, apply_channel_grid, harq_forgetting_factor


@dataclass(frozen=True)
class DlsimConfig:
    mcs: int = 4
    n_rb: int = 25
    n_pdcch_symbols: int = 1
    subframe: int = 7
    rnti: int = 0x1234
    n_id_cell: int = 0
    n_turbo_iter: int = 8
    batch: int = 64           # subframes per jitted step


class DlsimAwgn:
    """AWGN + perfect channel knowledge downlink link-level simulator."""

    def __init__(self, cfg: DlsimConfig):
        self.cfg = cfg
        self.dlsch = DlschCodec(DlschConfig(
            mcs=cfg.mcs, n_rb=cfg.n_rb,
            n_pdcch_symbols=cfg.n_pdcch_symbols,
            n_turbo_iter=cfg.n_turbo_iter))
        self.fp = FrameParms(n_rb=cfg.n_rb, n_id_cell=cfg.n_id_cell)
        self.gm = make_grid_map(cfg.n_rb, cfg.n_pdcch_symbols,
                                cfg.n_id_cell, cfg.subframe)
        G = self.dlsch.cfg.G
        assert self.gm.n_data_re * self.dlsch.cfg.Qm == G, \
            (self.gm.n_data_re, G)
        cinit = pdsch_cinit(cfg.rnti, 0, 2 * cfg.subframe, cfg.n_id_cell)
        self.scr_seq = gold_sequence(cinit, G)
        self._step = jax.jit(self._trial_step)

    def _trial_step(self, keys, n0):
        """One batched trial. `keys`: [B] PRNG keys — one per subframe trial,
        so the batch axis shards cleanly over a device mesh (DP over UE
        channels, SURVEY.md §2.12 P4)."""
        cfg = self.cfg
        codec = self.dlsch
        B = keys.shape[0]
        Qm = codec.cfg.Qm
        splits = jax.vmap(jax.random.split)(keys)       # [B, 2, key]
        k_bits, k_noise = splits[:, 0], splits[:, 1]
        tb = jax.vmap(lambda k: jax.random.bernoulli(
            k, 0.5, (codec.cfg.tbs,)))(k_bits).astype(jnp.int32)
        # --- TX chain -------------------------------------------------------
        e = codec.encode(tb)
        e = scramble_bits(e, self.scr_seq)
        sym = map_symbols(e, Qm)
        grid = fill_grid(sym.astype(jnp.complex64), self.gm)
        t = ofdm.ofdm_modulate(grid, self.fp)
        # --- channel: AWGN --------------------------------------------------
        nr = jax.vmap(lambda k: jax.random.normal(k, t.shape[1:] + (2,)))(k_noise)
        noise = jnp.sqrt(n0 / 2) * (nr[..., 0] + 1j * nr[..., 1])
        rx = t + noise
        # --- RX chain -------------------------------------------------------
        rgrid = ofdm.ofdm_demodulate(rx, self.fp)
        y = extract_data_res(rgrid, self.gm)
        llr = demap_llr(y, n0, Qm).reshape(B, -1)
        llr = unscramble_llrs(llr, self.scr_seq)
        tb_hat, tb_ok, _ = codec.decode(llr)
        bit_errs = jnp.sum(jnp.abs(tb_hat - tb), axis=1)
        return tb_ok, bit_errs

    def run_snr(self, snr_db: float, n_frames: int, seed: int = 0):
        """Round-0 BLER at one SNR. Returns (errors, trials)."""
        n0 = jnp.float32(10.0 ** (-snr_db / 10.0))
        errs = trials = 0
        n_steps = -(-n_frames // self.cfg.batch)
        for i in range(n_steps):
            keys = jnp.asarray(host_keys(seed, self.cfg.batch, stream=i))
            ok, _ = self._step(keys, n0)
            ok = np.asarray(ok)
            errs += int((~ok).sum())
            trials += len(ok)
        return errs, trials

    def sweep(self, snrs, n_frames: int, seed: int = 0, verbose: bool = True,
              early_exit: bool = True):
        """SNR sweep; returns list of (snr, errs, trials, bler)."""
        rows = []
        for s in snrs:
            errs, trials = self.run_snr(float(s), n_frames, seed)
            bler = errs / trials
            rows.append((float(s), errs, trials, bler))
            if verbose:
                print(f"SNR {s:+6.2f} dB: BLER {bler:.4f} ({errs}/{trials})")
            if early_exit and errs == 0:
                break
        return rows


def dlsim_snr_offset_db(gm) -> float:
    """Reference-dlsim SNR convention offset (dB).

    dlsim.c:2852 sets sigma2 from the subframe's *average* TX energy spread
    over every grid RE: sigma2 = mean_grid_energy_per_RE / SNR. Because the
    control region is mostly empty (dlsim transmits exactly ONE
    UE-specific DCI at aggregation L=1 = 36 QPSK REs — dlsim.c:1155, the
    common DCI is commented out at :1028-1036 — plus PCFICH 16 REs, no
    PHICH; generate_dci_top leaves NIL CCEs at zero power) while PDSCH
    symbols are full, the effective per-data-RE Es/N0 exceeds the
    nominal SNR by
        delta = 10*log10(N_grid / N_filled).
    Our native convention ("per_re") defines SNR directly per data RE; use
    snr_convention="dlsim" to compare against reference corpus numbers.
    (Round-4 correction: 72 -> 36 control REs after reading the dlsim DCI
    setup — worth 0.02 dB, below the campaigns' reporting precision.)
    """
    n_grid = gm.fp.symbols_per_subframe * gm.fp.n_sc
    n_rs = 8 * gm.fp.n_rb                    # 4 pilot syms x 2 RS/RB (port 0)
    n_filled = gm.n_data_re + n_rs + 36 + 16
    return float(10.0 * np.log10(n_grid / n_filled))


@dataclass(frozen=True)
class DlsimFadingConfig:
    mcs: int = 5
    n_rb: int = 50
    channel: str = "EVA"          # PROFILES key; "AWGN" for flat
    n_harq_rounds: int = 4        # rv = round & 3 (dlsim.c:2175)
    perfect_ce: bool = False      # dlsim -F flag equivalent
    n_rx: int = 1                 # dlsim -z (reference default 2, MRC)
    harq_doppler_hz: float = 0.0  # >0: AR(1)-correlated fade across HARQ
    #   rounds with rho = J0(2*pi*fd*8ms) (Jakes at the HARQ RTT). 0 matches
    #   the reference dlsim exactly: hold_channel=0, fresh iid channel every
    #   round (dlsim.c:2156).
    delay_scale: float = 1.0      # tap-delay multiplier; 0.651 reproduces
    #   the reference corpus' compressed delay spread (channels.ChannelModel
    #   docstring + VALIDATION.md root-cause note)
    est_mode: str = "interp"      # "interp" (per-pilot-symbol Wiener +
    #   time interpolation, the reference's high_speed mode), "joint"
    #   (quasi-static 2D LMMSE over all pilot symbols — ~3 dB better
    #   estimation, physically valid at the corpus 5-70 Hz Dopplers) or
    #   "dd" (joint + a decision-directed second pass: detected data REs
    #   act as a dense pilot field, channel_est.dd_refine — buys back
    #   pilot-density loss at the 16QAM corpus points, r5 item 4)
    snr_convention: str = "per_re"  # "per_re" (Es/N0 per data RE) or
    #   "dlsim" (reference dlsim.c:2852 grid-average convention; see
    #   dlsim_snr_offset_db) — use "dlsim" when comparing to the corpus.
    est_prior: str = "adaptive"   # joint-estimator delay prior:
    #   "adaptive" (default, r4: MEASURED from received pilots by a
    #   one-batch probe, channel_est.measure_delay_prior — no genie
    #   knowledge; the delay-spread estimation real receivers run;
    #   worth ~0.1 dB on EVA vs the generic prior), "exp" (generic CP/8
    #   decay) or "pdp" (matched to the channel model's actual scaled
    #   PDP — the genie bound). Only est_mode="joint" consumes it.
    use_est_err_var: bool = True  # feed the estimator's posterior error
    #   variance into the LLR noise term (ablation knob)
    n_pdcch_symbols: int = 1
    subframe: int = 7
    rnti: int = 0x1234
    n_id_cell: int = 0
    n_turbo_iter: int = 8
    batch: int = 64
    time_domain_channel: bool = False   # convolve the SAMPLE STREAM with
    #   the band-limited tap FIR (the reference's multipath_channel,
    #   multipath_channel.c:152) instead of the per-subcarrier multiply.
    #   The two are identical while the delay spread fits the CP; beyond
    #   it (ETU at 1.4 MHz, CP 9 samples < 9.6-sample spread) only this
    #   path carries the real inter-symbol interference.
    intra_doppler_hz: float = 0.0   # >0: the channel varies WITHIN the
    #   subframe — per-OFDM-symbol tap states with the exact Jakes
    #   autocorrelation across the 14 symbol centers
    #   (channels.draw_taps_timevar). This is the high-speed axis of the
    #   reference's BLER_SIMULATIONS/bler_{66..550}.m corpus; use
    #   est_mode="interp" (the reference's high-speed estimator analog).
    with_pdcch: bool = True       # transmit PCFICH + the UE's format-1A
    #   DCI and BLIND-DECODE it per trial/round; a missed DCI voids the
    #   round (dlsim.c:3011-3023 -> dci_decoding_procedure). The dci_err
    #   column of campaign CSVs counts real misses (VERDICT r4 weak #5).


class DlsimFading:
    """Fading-channel downlink simulator with HARQ and channel estimation.

    Per trial and HARQ round: fresh iid channel draw (the reference dlsim's
    hold_channel=0 / forgetting_factor=0 default, dlsim.c:2156), rv cycling
    0,1,2,3, soft combining in the per-block circular buffers. n_rx>1 adds
    per-antenna estimation + MRC (dlsch_detection_mrc, demodulation.c:2583).
    """

    def __init__(self, cfg: DlsimFadingConfig):
        self.cfg = cfg
        self.dlsch = DlschCodec(DlschConfig(
            mcs=cfg.mcs, n_rb=cfg.n_rb,
            n_pdcch_symbols=cfg.n_pdcch_symbols,
            n_turbo_iter=cfg.n_turbo_iter))
        self.fp = FrameParms(n_rb=cfg.n_rb, n_id_cell=cfg.n_id_cell)
        self.gm = make_grid_map(cfg.n_rb, cfg.n_pdcch_symbols,
                                cfg.n_id_cell, cfg.subframe)
        self.chan = ChannelModel(name=cfg.channel, fp=self.fp,
                                 n_rx=cfg.n_rx,
                                 delay_scale=cfg.delay_scale)
        self.harq_ff = (harq_forgetting_factor(cfg.harq_doppler_hz)
                        if cfg.harq_doppler_hz > 0 else 0.0)
        G = self.dlsch.cfg.G
        assert self.gm.n_data_re * self.dlsch.cfg.Qm == G
        cinit = pdsch_cinit(cfg.rnti, 0, 2 * cfg.subframe, cfg.n_id_cell)
        self.scr_seq = gold_sequence(cinit, G)
        self.dci_miss = 0
        # a 1.4 MHz cell with CFI=1 has zero CCEs (the reference requires
        # CFI>=2 at 6 PRB): no PDCCH can exist, fall back silently
        self.pdcch_on = cfg.with_pdcch
        if cfg.with_pdcch:
            self._init_pdcch()
        # Per-HARQ-round jitted programs (rv and first-round flag are
        # compile-time): one small program per round instead of a single
        # R-times-unrolled graph, which would compile R times slower.
        self._tx = jax.jit(self._tx_encode)
        self._rounds = {}

    def _init_pdcch(self):
        """Real control region: PCFICH + the scheduled UE's format-1A DCI
        at the largest aggregation its search spaces allow (a cell-edge
        eNB's choice), blind-decoded per round at the UE."""
        from ..phy.control_region import make_control_region_map
        from ..phy.pdcch import (pack_dci_format1a, dci_encode,
                                 pdcch_scramble_seq, cfi_encode,
                                 common_search_candidates,
                                 ue_search_candidates, BITS_PER_CCE)
        cfg = self.cfg
        ns = 2 * cfg.subframe
        self.crm = make_control_region_map(cfg.n_rb, cfg.n_pdcch_symbols,
                                           cfg.n_id_cell)
        n_cce = self.crm.n_cce
        common = common_search_candidates(n_cce)
        uespec = ue_search_candidates(n_cce, cfg.rnti, cfg.subframe)
        self.dci_cands = common + [c for c in uespec if c not in common]
        if not self.dci_cands:
            self.pdcch_on = False
            return
        cand = max(self.dci_cands, key=lambda c: c.L)
        self.dci_payload = pack_dci_format1a(
            cfg.n_rb, rb_start=0, n_prb=cfg.n_rb, mcs=cfg.mcs,
            harq_pid=0, ndi=1, rv=0)
        e = dci_encode(self.dci_payload, cfg.rnti, cand.L)
        self.pdcch_scr = pdcch_scramble_seq(cfg.n_id_cell, ns,
                                            n_cce * BITS_PER_CCE)
        full = np.zeros(n_cce * BITS_PER_CCE, np.int8)
        off = cand.cce_offset * BITS_PER_CCE
        full[off:off + len(e)] = e ^ self.pdcch_scr[off:off + len(e)]
        used = np.zeros(len(full) // 2, bool)
        used[off // 2:(off + len(e)) // 2] = True
        syms = ((1 - 2 * full[0::2]) + 1j * (1 - 2 * full[1::2])) \
            / np.sqrt(2)
        self.pdcch_syms = np.where(used, syms, 0).astype(np.complex64)
        cinit = ((ns // 2 + 1) * (2 * cfg.n_id_cell + 1) << 9) \
            + cfg.n_id_cell
        b = cfi_encode(cfg.n_pdcch_symbols) \
            ^ gold_sequence(cinit, 32).astype(np.int8)
        self.pcfich_syms = (((1 - 2 * b[0::2]) + 1j * (1 - 2 * b[1::2]))
                            / np.sqrt(2)).astype(np.complex64)

    def _prior(self):
        if self.cfg.est_prior == "adaptive":
            return self._adaptive_prior
        if self.cfg.est_prior != "pdp":
            return None
        from ..phy.channel_est import pdp_prior
        from .channels import PROFILES
        delays_us, amps_db = PROFILES[self.cfg.channel]
        return pdp_prior(self.fp, delays_us,
                         10.0 ** (0.1 * np.asarray(amps_db)),
                         self.cfg.delay_scale)

    def _measure_prior(self, snr_db: float, n_probe: int = 64,
                      seed: int = 9090) -> np.ndarray:
        """One probe batch: pilots through a fresh channel draw + AWGN,
        then channel_est.measure_delay_prior on the received grid (the
        receiver-side delay-spread estimation; uses no channel-model
        knowledge)."""
        from ..phy.channel_est import measure_delay_prior
        cfg = self.cfg
        n0 = 10.0 ** (-snr_db / 10.0)
        probe_chan = ChannelModel(name=cfg.channel, fp=self.fp, n_rx=1,
                                  delay_scale=cfg.delay_scale)

        @jax.jit
        def probe(keys):
            splits = jax.vmap(jax.random.split)(keys)
            sym = jnp.zeros((n_probe, len(self.gm.data_sc)), jnp.complex64)
            grid = fill_grid(sym, self.gm)          # pilots only
            taps = probe_chan.draw_taps(splits[:, 0], n_probe)
            H = probe_chan.freq_response(taps)
            grid = apply_channel_grid(grid, H, self.fp)
            t = ofdm.ofdm_modulate(grid, self.fp)
            nr = jax.vmap(lambda k: jax.random.normal(
                k, t.shape[1:] + (2,)))(splits[:, 1])
            rx = t + jnp.sqrt(jnp.float32(n0) / 2) \
                * (nr[..., 0] + 1j * nr[..., 1])
            return ofdm.ofdm_demodulate(rx, self.fp)

        rgrid = np.asarray(probe(jnp.asarray(host_keys(seed, n_probe,
                                                       stream=777))))
        return measure_delay_prior(rgrid, self.gm, n0)

    def _ensure_prior(self, snr_db: float) -> None:
        if self.cfg.est_prior == "adaptive" and \
                getattr(self, "_adaptive_prior", None) is None:
            self._adaptive_prior = self._measure_prior(snr_db)

    def wiener(self, snr_db: float):
        n0 = 10.0 ** (-snr_db / 10.0)
        if self.cfg.est_mode == "dd":
            from ..phy.channel_est import make_dd_smoother
            self._ensure_prior(snr_db)
            wj = make_wiener_joint(self.gm, n0, prior=self._prior())
            wd, _ = make_dd_smoother(self.gm, n0, prior=self._prior())
            return (jnp.asarray(wj), jnp.asarray(wd))
        if self.cfg.est_mode == "joint":
            self._ensure_prior(snr_db)
            return jnp.asarray(make_wiener_joint(self.gm, n0,
                                                 prior=self._prior()))
        return jnp.asarray(make_wiener_stack(self.gm, n0))

    def err_var(self, snr_db: float):
        """[n_data] per-RE estimation-error variance (0 for perfect CE /
        interp mode, where the old behavior is preserved)."""
        if self.cfg.perfect_ce or not self.cfg.use_est_err_var \
                or self.cfg.est_mode not in ("joint", "dd"):
            return jnp.zeros(len(self.gm.data_sc), jnp.float32)
        self._ensure_prior(snr_db)
        if self.cfg.est_mode == "dd":
            from ..phy.channel_est import make_dd_smoother
            _, post = make_dd_smoother(self.gm,
                                       10.0 ** (-snr_db / 10.0),
                                       prior=self._prior())
            return jnp.asarray(post[self.gm.data_sc])
        ev = joint_err_var(self.gm, 10.0 ** (-snr_db / 10.0),
                           prior=self._prior())
        return jnp.asarray(ev[self.gm.data_sc])

    def _tx_encode(self, keys):
        """keys [B] -> (d_flats pytree, per-round (k_ch, k_noise) arrays)."""
        R = self.cfg.n_harq_rounds
        splits = jax.vmap(lambda k: jax.random.split(k, 2 + 2 * R))(keys)
        tb = jax.vmap(lambda k: jax.random.bernoulli(
            k, 0.5, (self.dlsch.cfg.tbs,)))(splits[:, 0]).astype(jnp.int32)
        d_flats = self.dlsch.encode_to_d(tb)
        k_ch = [splits[:, 2 + 2 * r] for r in range(R)]
        k_noise = [splits[:, 3 + 2 * r] for r in range(R)]
        return d_flats, k_ch, k_noise

    def _round_fn(self, rnd: int):
        """Build one round's jitted program. Signature (first round):
        (d_flats, k_ch, k_noise, n0, W) -> (ok, w_soft, taps); later rounds
        additionally take (w_soft, taps_prev) device carries."""
        cfg = self.cfg
        codec = self.dlsch
        A = cfg.n_rx
        Qm = codec.cfg.Qm
        rv = rnd & 3
        first = rnd == 0
        evolve = (not first) and self.harq_ff > 0.0
        data_sym = jnp.asarray(self.gm.data_sym)
        data_sc = jnp.asarray(self.gm.data_sc)
        if self.pdcch_on:
            crm = self.crm
            p_sym = np.asarray(crm.pdcch_sym)
            p_sc = np.asarray(crm.pdcch_sc)
            p_bin = np.asarray(crm.pdcch_bin)
            c_sym = np.asarray(crm.pcfich_sym)
            c_bin = np.asarray(crm.pcfich_bin)
            pd_sgn = np.asarray(
                1.0 - 2.0 * self.pdcch_scr.astype(np.float32))
            pd_expected = np.asarray(self.dci_payload.astype(np.int32))

        def f(d_flats, k_ch, k_noise, n0, wiener_stack, ev,
              w_soft=None, taps_prev=None):
            B = k_ch.shape[0]
            e = codec.select_e(d_flats, rv)
            e = scramble_bits(e, self.scr_seq)
            sym = map_symbols(e, Qm)
            grid = fill_grid(sym.astype(jnp.complex64), self.gm)
            if self.pdcch_on:
                grid = grid.at[:, jnp.asarray(p_sym),
                               jnp.asarray(p_bin)].set(
                    jnp.broadcast_to(jnp.asarray(self.pdcch_syms),
                                     (B, len(self.pdcch_syms))))
                grid = grid.at[:, jnp.asarray(c_sym),
                               jnp.asarray(c_bin)].set(
                    jnp.broadcast_to(jnp.asarray(self.pcfich_syms), (B, 16)))
            # Channel for this round: fresh fade (the reference's
            # hold_channel=0, dlsim.c:2156) or AR(1) Jakes evolution at
            # the HARQ RTT when harq_doppler_hz is set.
            if cfg.intra_doppler_hz > 0:
                from .channels import (draw_taps_timevar,
                                       apply_channel_grid_timevar)
                assert A == 1 and not cfg.time_domain_channel
                taps_sym = draw_taps_timevar(self.chan, k_ch, B,
                                             cfg.intra_doppler_hz)
                grid_f, H_sym = apply_channel_grid_timevar(
                    grid, self.chan, taps_sym, self.fp)
                t = ofdm.ofdm_modulate(grid_f, self.fp)
                nr = jax.vmap(lambda k: jax.random.normal(
                    k, (A,) + t.shape[1:] + (2,)))(k_noise)
                noise = (nr[..., 0] + 1j * nr[..., 1]).reshape(B * A, -1)
                rx = t + jnp.sqrt(n0 / 2) * noise
                rgrid = ofdm.ofdm_demodulate(rx, self.fp)
                if cfg.perfect_ce:
                    H_data = H_sym[:, data_sym, data_sc][:, None, :]
                else:
                    est = (estimate_channel_joint
                           if cfg.est_mode == "joint"
                           else estimate_channel)
                    H_hat = est(rgrid, self.gm, wiener_stack)
                    H_data = H_hat[:, data_sym, data_sc].reshape(B, A, -1)
                y = extract_data_res(rgrid, self.gm).reshape(B, A, -1)
                llr = mrc_llr(jnp.moveaxis(y, 1, -1),
                              jnp.moveaxis(H_data, 1, -1),
                              n0 + ev, Qm).reshape(B, -1)
                llr = unscramble_llrs(llr, self.scr_seq)
                if self.pdcch_on:
                    from ..phy.pdcch import dci_blind_decode
                    y_c = rgrid[:, p_sym, p_bin].reshape(B, A, -1)
                    if cfg.perfect_ce:
                        H_c = H_sym[:, p_sym, p_sc][:, None, :]
                    else:
                        H_c = H_hat[:, p_sym, p_sc].reshape(B, A, -1)
                    llr_c = mrc_llr(jnp.moveaxis(y_c, 1, -1),
                                    jnp.moveaxis(H_c, 1, -1),
                                    n0, 2).reshape(B, -1)
                    dfound, dbits, _ = dci_blind_decode(
                        llr_c * jnp.asarray(pd_sgn),
                        len(self.dci_payload), cfg.rnti, self.dci_cands)
                    dci_ok = dfound & jnp.all(
                        dbits == jnp.asarray(pd_expected), axis=-1)
                    llr = llr * dci_ok[:, None]
                else:
                    dci_ok = jnp.ones(B, bool)
                _, ok, w_soft_out = codec.decode(llr, w_soft=w_soft, rv=rv)
                return ok & dci_ok, w_soft_out, taps_sym[:, 0], dci_ok
            if evolve:
                taps = self.chan.evolve_taps(taps_prev, k_ch, ff=self.harq_ff)
            else:
                taps = self.chan.draw_taps(k_ch, B)
            taps_rx = taps if A == 1 else taps[:, :, 0, :]  # [B(,A),T]
            if cfg.time_domain_channel:
                from .channels import apply_channel_time, fir_freq_response
                H = fir_freq_response(self.chan, taps_rx)   # for genie CE
                Hr = H[:, None] if A == 1 else H
                grid_a = grid if A == 1 else jnp.repeat(grid, A, axis=0)
                t = ofdm.ofdm_modulate(grid_a, self.fp)     # clean wave
                t = apply_channel_time(
                    t, self.chan, taps_rx.reshape(B * A, -1))
            else:
                H = self.chan.freq_response(taps_rx)        # [B(,A),n_sc]
                Hr = H[:, None] if A == 1 else H            # [B,A,n_sc]
                grid_a = grid if A == 1 else jnp.repeat(grid, A, axis=0)
                grid_a = apply_channel_grid(grid_a, Hr.reshape(B * A, -1),
                                            self.fp)
                t = ofdm.ofdm_modulate(grid_a, self.fp)     # [B*A, S]
            nr = jax.vmap(lambda k: jax.random.normal(
                k, (A,) + t.shape[1:] + (2,)))(k_noise)
            noise = (nr[..., 0] + 1j * nr[..., 1]).reshape(B * A, -1)
            rx = t + jnp.sqrt(n0 / 2) * noise
            rgrid = ofdm.ofdm_demodulate(rx, self.fp)       # [B*A,nsym,nfft]
            if cfg.perfect_ce:
                H_data = Hr[:, :, data_sc]                  # [B,A,n_data]
            elif cfg.est_mode == "dd":
                from ..phy.channel_est import qam_hard_slice, dd_refine
                Wj, Wd = wiener_stack
                H1 = estimate_channel_joint(rgrid, self.gm, Wj)
                h1 = H1[:, data_sym, data_sc].reshape(B, A, -1)
                y1 = extract_data_res(rgrid, self.gm).reshape(B, A, -1)
                # first-pass MRC symbol estimate -> hard decisions
                num = jnp.sum(jnp.conj(h1) * y1, axis=1)
                den = jnp.sum(jnp.abs(h1) ** 2, axis=1)
                x1 = num / jnp.maximum(den, 1e-9)   # ZF: unbiased
                #   amplitudes (MMSE shrinkage mis-slices the 16QAM ring)
                s_hat = qam_hard_slice(x1, Qm)
                # decision confidence: soft-erase REs whose equalized
                # symbol sits far from the decided point (wrong
                # decisions act as full-power noise in the LS field)
                d2 = jnp.abs(x1 - s_hat) ** 2 * den / jnp.maximum(n0, 1e-9)
                conf = jnp.exp(-0.5 * d2)
                s_rep = jnp.repeat(s_hat[:, None, :], A, axis=1
                                   ).reshape(B * A, -1)
                w_rep = jnp.repeat(conf[:, None, :], A, axis=1
                                   ).reshape(B * A, -1)
                H2 = dd_refine(y1.reshape(B * A, -1), s_rep, self.gm,
                               (Wd, None), weight=w_rep,
                               rgrid=rgrid)                # [B*A, n_sc]
                H_hat = jnp.broadcast_to(
                    H2[:, None, :], (B * A, self.fp.symbols_per_subframe,
                                     H2.shape[-1]))
                H_data = H2.reshape(B, A, -1)[:, :, data_sc]
            else:
                est = (estimate_channel_joint if cfg.est_mode == "joint"
                       else estimate_channel)
                H_hat = est(rgrid, self.gm, wiener_stack)
                H_data = H_hat[:, data_sym, data_sc].reshape(B, A, -1)
            y = extract_data_res(rgrid, self.gm).reshape(B, A, -1)
            # MRC across RX antennas (dlsch_detection_mrc :2583); A=1
            # degenerates to per-RE ZF. The estimation-error variance adds
            # to the per-RE noise (channel_est.joint_err_var). Compensation,
            # equalization and demap are one closed form (ops/equalize_llr).
            llr = mrc_llr(jnp.moveaxis(y, 1, -1),
                          jnp.moveaxis(H_data, 1, -1),
                          n0 + ev, Qm).reshape(B, -1)
            llr = unscramble_llrs(llr, self.scr_seq)
            if self.pdcch_on:
                # blind-decode THIS round's DCI; a miss means the UE
                # never saw the grant: its LLRs contribute nothing to
                # the soft buffer and the round fails (dlsim.c:3011)
                from ..phy.pdcch import dci_blind_decode
                y_c = rgrid[:, p_sym, p_bin].reshape(B, A, -1)
                if cfg.perfect_ce:
                    H_c = Hr[:, :, p_sc]
                else:
                    H_c = H_hat[:, p_sym, p_sc].reshape(B, A, -1)
                llr_c = mrc_llr(jnp.moveaxis(y_c, 1, -1),
                                jnp.moveaxis(H_c, 1, -1),
                                n0, 2).reshape(B, -1)
                dfound, dbits, _ = dci_blind_decode(
                    llr_c * jnp.asarray(pd_sgn), len(self.dci_payload),
                    cfg.rnti, self.dci_cands)
                dci_ok = dfound & jnp.all(
                    dbits == jnp.asarray(pd_expected), axis=-1)
                llr = llr * dci_ok[:, None]
            else:
                dci_ok = jnp.ones(B, bool)
            _, ok, w_soft_out = codec.decode(llr, w_soft=w_soft, rv=rv)
            return ok & dci_ok, w_soft_out, taps, dci_ok

        if first:
            return jax.jit(
                lambda d, kc, kn, n0, W, ev: f(d, kc, kn, n0, W, ev))
        return jax.jit(
            lambda d, kc, kn, n0, W, ev, ws, tp: f(d, kc, kn, n0, W, ev,
                                                   w_soft=ws, taps_prev=tp))

    def _round(self, rnd: int):
        key = (rnd == 0, rnd & 3)   # _round_fn depends on rnd only via these
        if key not in self._rounds:
            self._rounds[key] = self._round_fn(rnd)
        return self._rounds[key]

    def _step(self, keys, n0, W, ev=None):
        """One batched trial across all HARQ rounds (host-side round loop
        over per-round device programs; carries stay on device). Stage
        timings feed utils/profiler (the reference's time_meas wrapping of
        every stage, dlsim.c:3266+)."""
        import time as _time
        if ev is None:
            ev = jnp.zeros(len(self.gm.data_sc), jnp.float32)
        t0 = _time.perf_counter()
        d_flats, k_ch, k_noise = self._tx(keys)
        profiler.stop_meas("dlsim.tx_encode", t0, d_flats)
        reached = None
        ok_any = None
        w_soft = taps = None
        errs, reach_counts = [], []
        for rnd in range(self.cfg.n_harq_rounds):
            fn = self._round(rnd)
            t0 = _time.perf_counter()
            if rnd == 0:
                ok, w_soft, taps, dci_ok = fn(d_flats, k_ch[0], k_noise[0],
                                              n0, W, ev)
                ok_any = np.asarray(ok)
                reached = np.ones_like(ok_any)
            else:
                ok, w_soft, taps, dci_ok = fn(d_flats, k_ch[rnd],
                                              k_noise[rnd], n0, W, ev,
                                              w_soft, taps)
                ok_any = ok_any | np.asarray(ok)
            if rnd == 0:
                self.dci_miss += int((~np.asarray(dci_ok)).sum())
            profiler.stop_meas(f"dlsim.round{rnd}(chan+rx+decode)", t0)
            err_r = reached & ~ok_any
            errs.append(int(err_r.sum()))
            reach_counts.append(int(reached.sum()))
            reached = err_r
        return np.asarray(errs), np.asarray(reach_counts)

    def run_snr(self, snr_db: float, n_frames: int, seed: int = 0):
        """Returns per-round (errs [R], trials [R]) accumulated."""
        if self.cfg.snr_convention == "dlsim":
            snr_db = snr_db + dlsim_snr_offset_db(self.gm)
        n0 = jnp.float32(10.0 ** (-snr_db / 10.0))
        W = self.wiener(snr_db)
        ev = self.err_var(snr_db)
        R = self.cfg.n_harq_rounds
        self.dci_miss = 0        # round-0 blind-decode misses (dci_err)
        errs = np.zeros(R, np.int64)
        reach = np.zeros(R, np.int64)
        for i in range(-(-n_frames // self.cfg.batch)):
            keys = jnp.asarray(host_keys(seed, self.cfg.batch, stream=i))
            e, t = self._step(keys, n0, W, ev)
            errs += np.asarray(e, np.int64)
            reach += np.asarray(t, np.int64)
        return errs, reach

    def sweep(self, snrs, n_frames: int, seed: int = 0, verbose: bool = True,
              early_exit: bool = True, profile: bool = False,
              trace_dir: str | None = None):
        """SNR sweep. profile=True prints the per-stage time_meas table at
        exit (dlsim.c:3266+ parity); trace_dir records a Perfetto trace of
        one representative step (the VCD dumper's equivalent artifact)."""
        if trace_dir is not None:
            from ..utils.tracing import trace, annotate
            n0 = jnp.float32(10.0 ** (-float(snrs[0]) / 10.0))
            W = self.wiener(float(snrs[0]))
            keys = jnp.asarray(host_keys(seed, self.cfg.batch, stream=0))
            ev = self.err_var(float(snrs[0]))
            self._step(keys, n0, W, ev)        # compile outside the trace
            with trace(trace_dir):
                with annotate("dlsim.step"):
                    self._step(keys, n0, W, ev)
        rows = []
        for s in snrs:
            errs, reach = self.run_snr(float(s), n_frames, seed)
            bler = errs / np.maximum(reach, 1)
            rows.append((float(s), errs.copy(), reach.copy(), bler.copy()))
            if verbose:
                txt = " ".join(f"r{r}:{bler[r]:.3f}({errs[r]}/{reach[r]})"
                               for r in range(len(bler)))
                print(f"SNR {s:+6.2f} dB: {txt}", flush=True)
            if early_exit and errs[-1] == 0:
                break
        if profile:
            profiler.print_meas()
        return rows
