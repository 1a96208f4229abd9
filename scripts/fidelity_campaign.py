"""BASELINE.json fidelity configs 2-4: PUSCH 16QAM, 2x2 TxDiv 64QAM, 20 MHz
full chain with HARQ.

The reference ships no in-tree ULSCH / TxDiv / 20 MHz BLER corpus (only the
dlsim pdsch.txt + AWGN CSVs), so these runs establish OUR reference curves:
waterfall SNRs are recorded in VALIDATION.md and pinned by CPU CI anchors so
regressions are caught. Sanity bounds: each waterfall must sit within ~2 dB
of the matching-spectral-efficiency DL AWGN anchor (BASELINE.md table), and
the 2x2 TxDiv curve must show the diversity slope vs the 1x2 SISO curve.

Usage: python scripts/fidelity_campaign.py [n_trials] [out.json] [only]
One subprocess per config, one at a time: the parent process never
imports JAX, so each child has the card to itself (one JAX process per
card).
"""
import json
import os
import subprocess
import sys
import time

# repo importable without PYTHONPATH
sys.path.append(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

CONFIGS = ["ulsim16", "txdiv64", "harq20mhz"]


def run_ulsim16(n_trials, results):
    # config 2: 5 MHz PUSCH 16QAM (MCS 10, TBS 4008 @ 25 PRB), AWGN,
    # estimated channel (delay-domain LMMSE), counterpart of DL MCS10 anchor
    # (SNR@10% = 5.3 dB with the reference's Q15 RX).
    from openair4g_tpu.sim.ulsim import Ulsim, UlsimConfig
    sim = Ulsim(UlsimConfig(mcs=10, n_rb=25, n_rb_alloc=25, channel="AWGN",
                            batch=256, n_harq_rounds=1))
    rows = sim.sweep([3.0, 3.5, 4.0, 4.5, 5.0, 5.5, 6.0], n_trials)
    results["ulsim16"] = {
        "desc": "5MHz PUSCH 16QAM MCS10 AWGN estimated-CE round-0",
        "rows": [[r[0], int(r[1][0]), int(r[2][0]), float(r[3][0])]
                 for r in rows],
        "dl_awgn_counterpart_snr_at_10pct": 5.3,
    }


def run_txdiv64(n_trials, results):
    # config 3: 10 MHz 2x2 TxDiv (TM2 SFBC) 64QAM MCS25, EVA,
    # estimated per-port channel + Alamouti/MRC combining.
    from openair4g_tpu.sim.dlsim_mimo import DlsimTxDiv, DlsimTxDivConfig
    sim = DlsimTxDiv(DlsimTxDivConfig(mcs=25, n_rb=50, n_rx=2, channel="EVA",
                                      batch=128))
    rows = sim.sweep([12.0, 13.0, 14.0, 15.0, 16.0, 17.0, 18.0], n_trials)
    results["txdiv64"] = {
        "desc": "10MHz 2x2 TxDiv SFBC 64QAM MCS25 EVA estimated-CE round-0",
        "rows": [[r[0], int(r[1][0]), int(r[2][0]), float(r[3][0])]
                 for r in rows],
    }


def run_harq20mhz(n_trials, results):
    # config 4: 20 MHz full chain (100 PRB MCS15 16QAM), EVA fading,
    # 4 HARQ rounds rv cycling, estimated channel.
    from openair4g_tpu.sim.dlsim import DlsimFading, DlsimFadingConfig
    sim = DlsimFading(DlsimFadingConfig(
        mcs=15, n_rb=100, channel="EVA", n_rx=2, n_harq_rounds=4,
        batch=64, snr_convention="dlsim", est_mode="joint"))
    errs, reach = sim.run_snr(4.6, n_trials)
    results["harq20mhz"] = {
        "desc": "20MHz MCS15 EVA 1x2 4-round HARQ @ 4.6 dB (test6 config "
                "scaled to 100 PRB)",
        "errs": errs.tolist(), "reached": reach.tolist(),
        "bler": (errs / np.maximum(reach, 1)).tolist(),
    }


def main():
    n_trials = int(sys.argv[1]) if len(sys.argv) > 1 else 1024
    out_path = sys.argv[2] if len(sys.argv) > 2 else "fidelity_campaign.json"
    only = sys.argv[3] if len(sys.argv) > 3 else None
    if only is None:
        results = {}
        for name in CONFIGS:
            r = subprocess.run([sys.executable, __file__, str(n_trials),
                                out_path + f".{name}", name])
            if r.returncode != 0:
                print(f"{name}: FAILED rc={r.returncode}", flush=True)
        for name in CONFIGS:
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
    results = {}
    t0 = time.time()
    {"ulsim16": run_ulsim16, "txdiv64": run_txdiv64,
     "harq20mhz": run_harq20mhz}[only](n_trials, results)
    results[only]["seconds"] = round(time.time() - t0, 1)
    with open(out_path, "w") as f:
        json.dump(results, f, indent=1)
    print(only, "done", flush=True)


if __name__ == "__main__":
    main()
