"""pbchsim equivalent: PBCH (MIB) BLER Monte-Carlo over AWGN.

Reference parity: openair1/SIMULATION/LTE_PHY/pbchsim.c — eNB PBCH TX ->
channel -> UE rx_pbch (channel estimation, QPSK LLR, blind Viterbi decode,
CRC16/antenna-mask check), BLER vs SNR.

One jitted step runs [batch] subframe-0 captures: pilots + PBCH -> OFDM ->
AWGN -> Wiener channel estimation -> MMSE equalize -> LLR -> blind decode
over 4 frame phases x antenna masks.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import jax
import jax.numpy as jnp

from ..config import FrameParms
from ..utils.rng import host_keys
from ..phy import ofdm
from ..phy.resource_grid import make_grid_map, fill_grid
from ..phy.channel_est import make_wiener_stack, estimate_channel
from ..phy.pbch import (pack_mib, make_pbch_map, pbch_frame_symbols,
                        pbch_blind_decode)
from ..ops.llr import demap_llr


@dataclass(frozen=True)
class PbchsimConfig:
    n_rb: int = 25
    n_id_cell: int = 0
    sfn: int = 0
    frame_phase: int = 0
    batch: int = 64
    perfect_ce: bool = False


class Pbchsim:
    def __init__(self, cfg: PbchsimConfig):
        self.cfg = cfg
        self.fp = FrameParms(n_rb=cfg.n_rb, n_id_cell=cfg.n_id_cell)
        self.mib = pack_mib(cfg.n_rb, cfg.sfn)
        self.pm = make_pbch_map(cfg.n_rb, cfg.n_id_cell)
        # pilot layout from the PDSCH grid map (subframe 0, pilots only)
        self.gm = make_grid_map(cfg.n_rb, 1, cfg.n_id_cell, subframe=0)
        self.pbch_syms = pbch_frame_symbols(
            self.mib, cfg.n_id_cell, cfg.frame_phase)
        self._jit = jax.jit(self._trial_step)

    def _trial_step(self, keys, n0, wiener):
        cfg, fp, pm = self.cfg, self.fp, self.pm
        B = keys.shape[0]
        grid = self._tx_grid(B)
        t = ofdm.ofdm_modulate(grid, fp)
        noise = jax.vmap(lambda k: jax.random.normal(
            k, (t.shape[1], 2)) * jnp.sqrt(n0 / 2))(keys)
        r = t + noise[..., 0] + 1j * noise[..., 1]
        rgrid = ofdm.ofdm_demodulate(r, fp)
        if cfg.perfect_ce:
            H = jnp.ones((B, len(pm.sym)), jnp.complex64)
        else:
            Hfull = estimate_channel(rgrid, self.gm, wiener, time_avg=True)
            H = Hfull[:, jnp.asarray(pm.sym), jnp.asarray(pm.sc)]
        y = rgrid[:, jnp.asarray(pm.sym), jnp.asarray(pm.bins)]
        # MMSE scalar equalize
        yeq = y * jnp.conj(H) / (jnp.abs(H) ** 2 + n0)
        llr2 = demap_llr(yeq, n0 / (jnp.abs(H) ** 2 + 1e-9), 2)  # [B,240,2]
        llr = llr2.reshape(B, 480)
        ok, mib_hat, phase, ant = pbch_blind_decode(llr, cfg.n_id_cell)
        mib_true = jnp.asarray(self.mib.astype(np.int32))
        exact = ok & jnp.all(mib_hat == mib_true, axis=-1) \
            & (phase == cfg.frame_phase)
        return exact

    def _tx_grid(self, B):
        grid = fill_grid(jnp.zeros((B, self.gm.n_data_re), jnp.complex64),
                         self.gm, with_pilots=True)
        pm = self.pm
        syms = jnp.broadcast_to(jnp.asarray(self.pbch_syms), (B, len(pm.sym)))
        return grid.at[:, jnp.asarray(pm.sym), jnp.asarray(pm.bins)].set(syms)

    def run_snr(self, snr_db: float, n_batches: int = 2, seed: int = 0):
        n0 = jnp.float32(10.0 ** (-snr_db / 10.0))
        # time_avg combines the 4 pilot symbols -> effective LS noise is
        # n0/4; build the Wiener prior for the post-average noise level
        wiener = jnp.asarray(make_wiener_stack(self.gm, float(n0) / 4.0))
        ok = tot = 0
        for i in range(n_batches):
            keys = jnp.asarray(host_keys(seed, self.cfg.batch, stream=i))
            exact = self._jit(keys, n0, wiener)
            ok += int(np.sum(np.asarray(exact)))
            tot += self.cfg.batch
        return dict(snr_db=snr_db, bler=1.0 - ok / tot, trials=tot)


def main():
    import argparse
    p = argparse.ArgumentParser(description="PBCH BLER sweep")
    p.add_argument("-B", "--n-rb", type=int, default=25)
    p.add_argument("-s", "--snr0", type=float, default=-10.0)
    p.add_argument("-S", "--snr1", type=float, default=-2.0)
    p.add_argument("--step", type=float, default=2.0)
    p.add_argument("-n", "--batches", type=int, default=2)
    p.add_argument("-F", "--perfect-ce", action="store_true")
    a = p.parse_args()
    sim = Pbchsim(PbchsimConfig(n_rb=a.n_rb, perfect_ce=a.perfect_ce))
    for snr in np.arange(a.snr0, a.snr1 + 1e-9, a.step):
        r = sim.run_snr(float(snr), n_batches=a.batches)
        print(f"SNR {snr:6.1f} dB  PBCH BLER {r['bler']:.4f} "
              f"({r['trials']} trials)")


if __name__ == "__main__":
    main()
