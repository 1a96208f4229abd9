"""mbmssim: PMCH/MBSFN link-level BLER simulator.

Reference parity: openair1/SIMULATION/LTE_PHY/mbmssim.c — eNB PMCH TX over
an extended-CP MBSFN subframe, MBSFN composite channel (several cells
transmitting the identical waveform at different delays), UE RX with MBSFN
RS channel estimation and MCH turbo decode.

The multi-cell single-frequency composite is an exact per-
subcarrier sum of delayed channel responses (each delay < extended CP), so
the whole SFN effect is one complex gain vector per trial.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import jax
import jax.numpy as jnp

from ..config import FrameParms
from ..utils.rng import host_keys
from ..phy.pdsch import DlschConfig, DlschCodec
from ..phy.pmch import (make_mbsfn_map, mbsfn_fill_grid,
                        mbsfn_estimate_channel, pmch_cinit)
from ..phy import ofdm
from ..ops.gold import gold_sequence, scramble_bits, unscramble_llrs
from ..ops.llr import map_symbols, demap_llr


@dataclass(frozen=True)
class MbmssimConfig:
    mcs: int = 4
    n_rb: int = 25
    n_id_mbsfn: int = 0
    subframe: int = 1
    n_sfn_cells: int = 3        # cells in the single-frequency network
    max_delay_frac: float = 0.8  # delays up to this fraction of the ECP
    perfect_ce: bool = False
    n_turbo_iter: int = 8
    batch: int = 64


class Mbmssim:
    def __init__(self, cfg: MbmssimConfig):
        self.cfg = cfg
        self.mm = make_mbsfn_map(cfg.n_rb, cfg.n_id_mbsfn, cfg.subframe)
        self.fp = self.mm.fp
        Qm = DlschConfig(mcs=cfg.mcs, n_rb=cfg.n_rb).Qm
        self.codec = DlschCodec(DlschConfig(
            mcs=cfg.mcs, n_rb=cfg.n_rb, n_turbo_iter=cfg.n_turbo_iter,
            g_override=self.mm.n_data_re * Qm))
        self.scr_seq = gold_sequence(
            pmch_cinit(cfg.n_id_mbsfn, cfg.subframe), self.codec.cfg.G)
        # subcarrier frequencies of all data/RS REs for delay phases
        self.f_all = np.arange(self.fp.n_sc) - 6 * self.fp.n_rb
        self.bins_all = self.fp.sc_to_bin(np.arange(self.fp.n_sc))
        self._step = jax.jit(self._trial_step)

    def _sfn_channel(self, key, B):
        """Composite SFN channel: n_cells unit-power rays at random delays
        within the extended CP, iid Rayleigh amplitudes. [B, n_sc]."""
        cfg, fp = self.cfg, self.fp
        k1, k2 = jax.random.split(key)
        d_max = cfg.max_delay_frac * fp.cp
        delays = jax.random.uniform(k1, (B, cfg.n_sfn_cells)) * d_max
        a = jax.random.normal(k2, (B, cfg.n_sfn_cells, 2))
        amps = (a[..., 0] + 1j * a[..., 1]) / np.sqrt(2 * cfg.n_sfn_cells)
        f = jnp.asarray(self.f_all, jnp.float32)
        phase = jnp.exp(-2j * np.pi * delays[..., None] * f
                        / fp.n_fft)                      # [B, C, n_sc]
        return jnp.sum(amps[..., None] * phase, axis=1)  # [B, n_sc]

    def _trial_step(self, keys, n0):
        cfg = self.cfg
        codec = self.codec
        B = keys.shape[0]
        Qm = codec.cfg.Qm
        splits = jax.vmap(lambda k: jax.random.split(k, 3))(keys)
        tb = jax.vmap(lambda k: jax.random.bernoulli(
            k, 0.5, (codec.cfg.tbs,)))(splits[:, 0]).astype(jnp.int32)
        e = codec.encode(tb)
        e = scramble_bits(e, self.scr_seq)
        sym = map_symbols(e, Qm).astype(jnp.complex64)
        grid = mbsfn_fill_grid(sym, self.mm)

        H = jax.vmap(lambda k: self._sfn_channel(k, 1)[0])(splits[:, 1])
        bins = jnp.asarray(self.bins_all)
        grid = grid.at[:, :, bins].multiply(H[:, None, :])
        t = ofdm.ofdm_modulate(grid, self.fp)
        nr = jax.vmap(lambda k: jax.random.normal(
            k, t.shape[1:] + (2,)))(splits[:, 2])
        rx = t + jnp.sqrt(n0 / 2) * (nr[..., 0] + 1j * nr[..., 1])
        rgrid = ofdm.ofdm_demodulate(rx, self.fp)

        if cfg.perfect_ce:
            h = H[:, self.mm.data_sc]
        else:
            h = mbsfn_estimate_channel(rgrid, self.mm, float(1e-2))
        y = rgrid[:, jnp.asarray(self.mm.data_sym),
                  jnp.asarray(self.mm.data_bin)]
        g = jnp.maximum(jnp.abs(h) ** 2, 1e-9)
        llr = demap_llr(y * jnp.conj(h) / g, n0 / g, Qm).reshape(B, -1)
        llr = unscramble_llrs(llr, self.scr_seq)
        tb_hat, ok, _ = codec.decode(llr)
        return ok, jnp.sum(jnp.abs(tb_hat - tb), axis=1)

    def run_snr(self, snr_db: float, n_frames: int, seed: int = 0):
        n0 = jnp.float32(10.0 ** (-snr_db / 10.0))
        errs = trials = 0
        for i in range(-(-n_frames // self.cfg.batch)):
            keys = jnp.asarray(host_keys(seed, self.cfg.batch, stream=i))
            ok, _ = self._step(keys, n0)
            ok = np.asarray(ok)
            errs += int((~ok).sum())
            trials += len(ok)
        return errs, trials

    def sweep(self, snrs, n_frames: int, seed: int = 0, verbose: bool = True,
              early_exit: bool = True):
        rows = []
        for s in snrs:
            errs, trials = self.run_snr(float(s), n_frames, seed)
            bler = errs / max(trials, 1)
            rows.append((float(s), errs, trials, bler))
            if verbose:
                print(f"SNR {s:+6.2f} dB: bler {bler:.4f} ({errs}/{trials})",
                      flush=True)
            if early_exit and errs == 0:
                break
        return rows
