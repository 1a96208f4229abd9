"""Fading/HARQ BLER validation campaign vs REFERENCE_DATA/pdsch.txt.

Reproduces the reference corpus operating points (dlsim commands in
openair1/SIMULATION/LTE_PHY/REFERENCE_DATA/pdsch.txt) with the exact
config of each test: 1 TX / 2 RX MRC (dlsim default n_rx=2), estimated
channel, 4 HARQ rounds with rv cycling, fresh iid channel per round
(dlsim.c:2156 hold_channel=0), EVA / ETU profiles.

Usage:  python scripts/fading_campaign.py [n_trials] [out.json]
Env OPENAIR4G_EST_MODE overrides the estimator ("dd" default — the
joint 2D-LMMSE first pass + decision-directed refinement of
channel_est.dd_refine, the receiver's best non-genie mode and the one
the corpus artifact records; "joint" = first pass only, r4's receiver,
kept in fading_campaign_joint.json for the ablation).
Runs on whatever backend JAX selects. One subprocess per config, one at
a time: the parent process never imports JAX, so each child has the card
to itself (one JAX process per card).
"""
import json
import os
import sys
import time

# repo importable without PYTHONPATH
sys.path.append(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

# (name, mcs, n_rb, n_pdcch, channel, snr_db, reference per-round BLER)
CORPUS = [
    ("test1",  5, 50, 2, "EVA", -2.8, (0.353, 0.034, 0.333, 0.0)),
    ("test5",  4,  6, 3, "EVA", -1.6, (0.325, 0.134, 0.0, None)),
    ("test6", 15, 50, 2, "EVA",  4.6, (0.409, 0.0097, 0.0, None)),
    ("test6b", 14, 25, 3, "EVA", 4.8, (0.381, 0.0, None, None)),
    ("test7", 15, 50, 2, "ETU", -1.0, (1.0, 0.937, 0.258, 0.033)),
    ("test7b", 14, 25, 3, "ETU", -1.0, (0.996, 0.896, 0.298, 0.060)),
    ("test10", 25, 25, 3, "EVA", 13.8, (0.421, 0.0, None, None)),
    ("test11", 26, 50, 2, "EVA", 14.6, (0.337, 0.0, None, None)),
]


def main():
    n_trials = int(sys.argv[1]) if len(sys.argv) > 1 else 2048
    out_path = sys.argv[2] if len(sys.argv) > 2 else "fading_campaign.json"
    only = sys.argv[3] if len(sys.argv) > 3 else None
    results = {}
    if only is None:
        import subprocess
        for name, *_ in CORPUS:
            r = subprocess.run(
                [sys.executable, __file__, str(n_trials),
                 out_path + f".{name}", name])
            if r.returncode != 0:
                print(f"{name}: FAILED rc={r.returncode}", flush=True)
        for name, *_ in CORPUS:
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
    for name, mcs, n_rb, c, chan, snr, ref in CORPUS:
        if name != only:
            continue
        batch = 128 if n_rb == 50 else 256
        est_mode = os.environ.get("OPENAIR4G_EST_MODE", "dd")
        cfg = DlsimFadingConfig(mcs=mcs, n_rb=n_rb, channel=chan,
                                n_pdcch_symbols=c, n_rx=2,
                                n_harq_rounds=4, batch=batch,
                                snr_convention="dlsim",
                                est_mode=est_mode)
        sim = DlsimFading(cfg)
        t0 = time.time()
        errs, reach = sim.run_snr(snr, n_trials)
        dt = time.time() - t0
        bler = (errs / np.maximum(reach, 1)).tolist()
        results[name] = {
            "est_mode": est_mode,
            "mcs": mcs, "n_rb": n_rb, "channel": chan, "snr_db": snr,
            "errs": errs.tolist(), "reached": reach.tolist(),
            "bler": bler, "ref_bler": list(ref), "seconds": round(dt, 1),
        }
        print(f"{name}: SNR {snr:+.1f} {chan} mcs{mcs} B{n_rb}  "
              f"bler={['%.3f' % b for b in bler]}  "
              f"ref={ref}  ({dt:.0f}s)", flush=True)
        with open(out_path, "w") as f:
            json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
