"""UE/eNB radio measurements: RSRP, RSSI, RSRQ, noise power, wideband CQI.

Reference parity: openair1/PHY/LTE_ESTIMATION/lte_ue_measurements.c
(RSRP from cell-specific RS REs, RSSI over the occupied band, RSRQ =
N_RB*RSRP/RSSI, N0 from non-pilot energy, wideband/subband CQI) and
lte_eNB_measurements.c (UL power/interference).

Every measurement is a masked reduction over the resource grid,
batched over trials; under a mesh these become psum'd statistics
(SURVEY.md §2.13 N17).
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from .resource_grid import GridMap


def measure(rgrid, gm: GridMap, H_hat=None, n0_hat=None):
    """rgrid [B, nsym, n_fft] -> dict of per-trial measurements.

    RSRP: mean |RE|^2 over port-0 RS positions (linear, per RE).
    RSSI: mean total power per occupied subcarrier over pilot symbols
          (the reference integrates over one symbol's N_RB*12 SCs).
    RSRQ: N_RB * RSRP / RSSI (36.214 definition, linear here).
    N0:   residual power at the OTHER port's pilot lattice when only port 0
          transmits is noise-only in SISO — estimated instead from the
          LS-vs-smoothed-channel residual if H_hat is given.
    """
    own = gm.pilot_port == 0
    psym = jnp.asarray(gm.pilot_sym[own])
    pbin = jnp.asarray(gm.pilot_bin[own])
    pval = jnp.asarray(np.conj(gm.pilot_val[own]).astype(np.complex64))

    rs_re = rgrid[:, psym, pbin]                        # [B, Np_tot]
    rsrp = jnp.mean(jnp.abs(rs_re) ** 2, axis=-1)

    # RSSI: total received power per occupied SC on the pilot symbols
    occ_bins = jnp.asarray(gm.fp.sc_to_bin(np.arange(gm.fp.n_sc)))
    psyms = jnp.asarray(np.unique(gm.pilot_sym[own]))
    band = rgrid[:, psyms][:, :, occ_bins]              # [B, n_ps, n_sc]
    rssi_per_sc = jnp.mean(jnp.abs(band) ** 2, axis=(-1, -2))

    rsrq = rsrp / jnp.maximum(rssi_per_sc, 1e-12)

    out = dict(rsrp=rsrp, rssi_per_sc=rssi_per_sc, rsrq=rsrq)

    if H_hat is not None:
        # noise estimate: LS-pilot estimate minus smoothed channel estimate
        ls = rs_re * pval
        h_at_p = H_hat[:, psym, jnp.asarray(gm.pilot_sc[own])]
        resid = ls - h_at_p
        out["n0_hat"] = jnp.mean(jnp.abs(resid) ** 2, axis=-1)
        sig = jnp.mean(jnp.abs(h_at_p) ** 2, axis=-1)
        out["snr_hat"] = sig / jnp.maximum(out["n0_hat"], 1e-12)
    return out


# 36.213 Table 7.2.3-1 CQI <-> spectral efficiency (bits/RE)
_CQI_EFF = np.array([0.0, 0.1523, 0.2344, 0.3770, 0.6016, 0.8770, 1.1758,
                     1.4766, 1.9141, 2.4063, 2.7305, 3.3223, 3.9023, 4.5234,
                     5.1152, 5.5547, 6.2266], np.float64)


def wideband_cqi(snr_linear):
    """SNR -> CQI index 0..15 via the AWGN capacity-to-efficiency map
    (the reference maps measured SINR through its own tables;
    lte_ue_measurements.c wideband_cqi_tot)."""
    eff = jnp.log2(1.0 + snr_linear)
    table = jnp.asarray(_CQI_EFF)
    # highest CQI whose efficiency is <= achieved efficiency
    ok = table[None, :] <= eff[..., None] * 0.9   # 1 dB implementation margin
    return jnp.sum(ok, axis=-1) - 1


def enb_measure_ul(rgrid, pm, n_alloc_rb_mask: np.ndarray):
    """eNB uplink measurements (reference lte_eNB_measurements.c): per-RB
    received power across the band, noise/interference floor from the RBs
    outside every allocation, and per-allocation SNR.

    rgrid [B, nsym, n_fft]; pm: scfdma.PuschMap (for the band geometry);
    n_alloc_rb_mask [n_rb] bool — True where *some* UE transmits.
    """
    fp = pm.fp
    occ = jnp.asarray(fp.sc_to_bin(np.arange(fp.n_sc)))
    band = rgrid[:, :, occ]                                # [B, nsym, n_sc]
    p_sc = jnp.mean(jnp.abs(band) ** 2, axis=1)            # [B, n_sc]
    p_rb = p_sc.reshape(p_sc.shape[0], fp.n_rb, 12).mean(-1)
    mask = jnp.asarray(n_alloc_rb_mask)
    n_empty = int((~n_alloc_rb_mask).sum())
    if n_empty:
        n0_hat = jnp.sum(jnp.where(~mask, p_rb, 0.0), -1) / n_empty
    else:
        n0_hat = jnp.zeros(p_rb.shape[0])
    n_used = max(int(n_alloc_rb_mask.sum()), 1)
    p_sig = jnp.sum(jnp.where(mask, p_rb, 0.0), -1) / n_used
    snr = (p_sig - n0_hat) / jnp.maximum(n0_hat, 1e-12)
    return dict(p_rb=p_rb, n0_hat=n0_hat,
                snr_db=10.0 * jnp.log10(jnp.maximum(snr, 1e-9)))
