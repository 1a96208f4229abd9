"""EVA5 round-0 BLER root-cause ablation (VERDICT round-2 item 2).

Hypothesis: the reference's random_channel.c:988 places tap l at FIR
sample position delays[l]*BW with BW = the *nominal* bandwidth in MHz
(dlsim.c:684-703: 1.25/5/10/20) while the signal is sampled at
f_s = ofdm_symbol_size*15 kHz (1.92/7.68/15.36/30.72 Msps), so the
reference corpus was generated with every tap delay compressed by
BW/f_s = 0.651 — a flatter channel than true 36.101 EVA/ETU. This
script reruns the corpus round-0 points with delay_scale=0.651 (and the
true 1.0 for reference), plus perfect-CE variants on test 6 to separate
estimation loss from channel statistics.

One subprocess per case, one at a time: the parent process never imports
JAX, so each child has the card to itself (one JAX process per card).

Usage: python scripts/eva_ablation.py [n_trials] [out.json] [only_case]
"""
import json
import os
import sys
import time

sys.path.append(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

REF_SCALE = 0.6510416667          # BW/f_s, identical at all LTE bandwidths

# (case, mcs, n_rb, n_pdcch, channel, snr_db, delay_scale, perfect_ce,
#  reference round-0 BLER, extra-config dict)
CASES = [
    ("test1_ref",  5, 50, 2, "EVA", -2.8, REF_SCALE, False, 0.353, {}),
    ("test6_ref", 15, 50, 2, "EVA",  4.6, REF_SCALE, False, 0.409, {}),
    ("test6b_ref", 14, 25, 3, "EVA", 4.8, REF_SCALE, False, 0.381, {}),
    ("test10_ref", 25, 25, 3, "EVA", 13.8, REF_SCALE, False, 0.421, {}),
    ("test11_ref", 26, 50, 2, "EVA", 14.6, REF_SCALE, False, 0.337, {}),
    ("test7_ref", 15, 50, 2, "ETU", -1.0, REF_SCALE, False, 1.0, {}),
    # --- round-4 discriminating ablations on test 6 @ 0.651 ------------
    # E1: estimation loss removed entirely
    ("test6_ref_pce", 15, 50, 2, "EVA", 4.6, REF_SCALE, True, None, {}),
    # E2: genie delay prior (estimator matched to the compressed PDP)
    ("test6_ref_pdp", 15, 50, 2, "EVA", 4.6, REF_SCALE, False, None,
     dict(est_prior="pdp")),
    # E2b: MEASURED prior (receiver-side delay-spread estimation)
    ("test6_ref_adaptive", 15, 50, 2, "EVA", 4.6, REF_SCALE, False, None,
     dict(est_prior="adaptive")),
    ("test10_ref_adaptive", 25, 25, 3, "EVA", 13.8, REF_SCALE, False,
     None, dict(est_prior="adaptive")),
    # E3: per-pilot-symbol interp estimator (the reference's mode analog)
    ("test6_ref_interp", 15, 50, 2, "EVA", 4.6, REF_SCALE, False, None,
     dict(est_mode="interp")),
    # E5: single RX chain (MRC handling out of the loop)
    ("test6_ref_1rx", 15, 50, 2, "EVA", 4.6, REF_SCALE, False, None,
     dict(n_rx=1)),
    # E6: estimation-error variance NOT fed to the LLR noise term
    ("test6_ref_noev", 15, 50, 2, "EVA", 4.6, REF_SCALE, False, None,
     dict(use_est_err_var=False)),
    # E4: dB quantification — SNR offsets around the operating point
    ("test6_ref_p05", 15, 50, 2, "EVA", 5.1, REF_SCALE, False, None, {}),
    ("test6_ref_p10", 15, 50, 2, "EVA", 5.6, REF_SCALE, False, None, {}),
    # same discriminators on the 64QAM outlier (test 10)
    ("test10_ref_pce", 25, 25, 3, "EVA", 13.8, REF_SCALE, True, None, {}),
    ("test10_ref_pdp", 25, 25, 3, "EVA", 13.8, REF_SCALE, False, None,
     dict(est_prior="pdp")),
    ("test10_ref_p05", 25, 25, 3, "EVA", 14.3, REF_SCALE, False, None, {}),
    # estimation-loss split under true channel statistics
    ("test6_true_pce", 15, 50, 2, "EVA", 4.6, 1.0, True, None, {}),
    # true-delay controls (should reproduce fading_campaign.json)
    ("test6_true", 15, 50, 2, "EVA", 4.6, 1.0, False, None, {}),
    ("test1_true", 5, 50, 2, "EVA", -2.8, 1.0, False, None, {}),
]


def main():
    n_trials = int(sys.argv[1]) if len(sys.argv) > 1 else 1024
    out_path = sys.argv[2] if len(sys.argv) > 2 else "eva_ablation.json"
    only = sys.argv[3] if len(sys.argv) > 3 else None
    if only is None:
        import subprocess
        results = {}
        for name, *_ in CASES:
            r = subprocess.run([sys.executable, __file__, str(n_trials),
                                out_path + f".{name}", name])
            if r.returncode != 0:
                print(f"{name}: FAILED rc={r.returncode}", flush=True)
        for name, *_ in CASES:
            try:
                with open(out_path + f".{name}") as f:
                    results.update(json.load(f))
                os.unlink(out_path + f".{name}")
            except FileNotFoundError:
                pass
        with open(out_path, "w") as f:
            json.dump(results, f, indent=1)
        print("wrote", out_path)
        return
    from openair4g_tpu.sim.dlsim import DlsimFading, DlsimFadingConfig
    for name, mcs, n_rb, c, chan, snr, scale, pce, ref, extra in CASES:
        if name != only:
            continue
        batch = 128 if n_rb == 50 else 256
        kw = dict(n_rx=2, est_mode="joint")
        kw.update(extra)
        cfg = DlsimFadingConfig(mcs=mcs, n_rb=n_rb, channel=chan,
                                n_pdcch_symbols=c,
                                n_harq_rounds=1, batch=batch,
                                delay_scale=scale, perfect_ce=pce,
                                snr_convention="dlsim", **kw)
        sim = DlsimFading(cfg)
        t0 = time.time()
        errs, reach = sim.run_snr(snr, n_trials)
        dt = time.time() - t0
        bler = float(errs[0] / max(reach[0], 1))
        res = {name: dict(mcs=mcs, n_rb=n_rb, channel=chan, snr_db=snr,
                          delay_scale=scale, perfect_ce=pce,
                          errs=int(errs[0]), trials=int(reach[0]),
                          bler=bler, ref_bler=ref, extra=extra,
                          seconds=round(dt, 1))}
        print(f"{name}: bler={bler:.3f} ref={ref} ({dt:.0f}s)", flush=True)
        with open(out_path, "w") as f:
            json.dump(res, f, indent=1)


if __name__ == "__main__":
    main()
