"""syncsim equivalent: cell-search detection-rate Monte-Carlo.

Reference parity: openair1/SIMULATION/LTE_PHY/syncsim.c (drives
initial_sync over SNR / timing-offset grid) and
LTE_TRANSPORT/initial_sync.c:274.

Each jitted trial step builds [batch] 5 ms captures containing one subframe-0
waveform (PSS symbol 6 + SSS symbol 5, FDD normal CP) at a random timing
offset, applies AWGN (and optionally a CFO), runs the batched matched-filter
cell search, and scores Nid/timing detection.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import jax
import jax.numpy as jnp

from ..config import FrameParms
from ..utils.rng import host_keys
from ..phy import ofdm
from ..phy.sync import (CellSearch, pss_sequence, sss_sequence,
                        center62_bins, estimate_cfo)


@dataclass(frozen=True)
class SyncsimConfig:
    n_rb: int = 25
    nid1: int = 0
    nid2: int = 0
    batch: int = 32
    cfo_scs: float = 0.0      # carrier frequency offset in subcarrier spacings


class Syncsim:
    def __init__(self, cfg: SyncsimConfig):
        self.cfg = cfg
        self.fp = FrameParms(n_rb=cfg.n_rb,
                             n_id_cell=3 * cfg.nid1 + cfg.nid2)
        fp = self.fp
        bins = center62_bins(fp)
        grid = np.zeros((1, fp.symbols_per_subframe, fp.n_fft), np.complex64)
        grid[0, 5, bins] = sss_sequence(cfg.nid1, cfg.nid2, False)
        grid[0, 6, bins] = pss_sequence(cfg.nid2)
        self.subframe_t = ofdm.ofdm_modulate_host(grid, fp)[0].astype(
            np.complex64)
        self.search = CellSearch(fp)
        # sample index (within the subframe waveform) where the PSS symbol's
        # useful part begins: skip symbols 0..5 then symbol 6's CP
        self.pss_t0 = (fp.cp0 + fp.n_fft) + 5 * (fp.cp + fp.n_fft) + fp.cp
        self.max_off = self.search.capture_len - fp.samples_per_tti - fp.n_fft
        # per-sample signal power of the sync symbols (62 REs in n_fft bins,
        # unitary FFT => symbol power = 62/n_fft per sample over sync symbols)
        self._step = jax.jit(self._trial_step)

    def _trial_step(self, keys, n0):
        """keys [B,2] uint32, n0 = per-sample noise variance. Returns
        (nid_ok [B], pos_err [B], cfo_hat [B])."""
        cfg, fp = self.cfg, self.fp
        B = keys.shape[0]
        L = self.search.capture_len

        def one(key):
            koff, kn = jax.random.split(key)
            off = jax.random.randint(koff, (), 0, self.max_off)
            cap = jnp.zeros((L,), jnp.complex64)
            cap = jax.lax.dynamic_update_slice(
                cap, jnp.asarray(self.subframe_t), (off,))
            if cfg.cfo_scs:
                ph = 2j * np.pi * cfg.cfo_scs / fp.n_fft
                cap = cap * jnp.exp(ph * jnp.arange(L))
            noise = jax.random.normal(kn, (L, 2)) * jnp.sqrt(n0 / 2)
            cap = cap + noise[:, 0] + 1j * noise[:, 1]
            return cap, off

        caps, offs = jax.vmap(one)(keys)
        res = self.search.search(caps)
        true_pos = offs + self.pss_t0
        nid_ok = ((res["nid2"] == cfg.nid2) & (res["nid1"] == cfg.nid1)
                  & (res["half"] == 0))
        pos_err = res["pss_pos"] - true_pos
        cfo = estimate_cfo(caps, res["pss_pos"], res["nid2"], fp.n_fft)
        return nid_ok, pos_err, cfo

    def run_snr(self, snr_db: float, n_batches: int = 4, seed: int = 0):
        """Detection statistics at one SNR (per occupied sync RE)."""
        fp = self.fp
        # SNR defined on the sync-symbol REs: signal RE energy 1 (unitary),
        # so per-sample N0 = 10^(-snr/10) gives Es/N0 = snr on each RE.
        n0 = jnp.float32(10.0 ** (-snr_db / 10.0))
        ok = err = tot = 0
        cfo_abs = 0.0
        for i in range(n_batches):
            keys = jnp.asarray(host_keys(seed, self.cfg.batch, stream=i))
            nid_ok, pos_err, cfo = self._step(keys, n0)
            ok += int(np.sum(np.asarray(nid_ok)))
            err += int(np.sum(np.abs(np.asarray(pos_err)) > 2))
            cfo_abs += float(np.sum(np.abs(np.asarray(cfo))))
            tot += self.cfg.batch
        return dict(snr_db=snr_db, det_rate=ok / tot,
                    timing_err_rate=err / tot, mean_abs_cfo=cfo_abs / tot)


def main():
    import argparse
    p = argparse.ArgumentParser(description="cell-search detection sweep")
    p.add_argument("-B", "--n-rb", type=int, default=25)
    p.add_argument("-s", "--snr0", type=float, default=-12.0)
    p.add_argument("-S", "--snr1", type=float, default=0.0)
    p.add_argument("--step", type=float, default=2.0)
    p.add_argument("-n", "--batches", type=int, default=4)
    p.add_argument("--nid1", type=int, default=0)
    p.add_argument("--nid2", type=int, default=0)
    p.add_argument("--cfo", type=float, default=0.0)
    a = p.parse_args()
    sim = Syncsim(SyncsimConfig(n_rb=a.n_rb, nid1=a.nid1, nid2=a.nid2,
                                cfo_scs=a.cfo))
    for snr in np.arange(a.snr0, a.snr1 + 1e-9, a.step):
        r = sim.run_snr(float(snr), n_batches=a.batches)
        print(f"SNR {snr:6.1f} dB  det {r['det_rate']:.3f}  "
              f"timing_err {r['timing_err_rate']:.3f}  "
              f"|cfo| {r['mean_abs_cfo']:.4f} scs")


if __name__ == "__main__":
    main()
