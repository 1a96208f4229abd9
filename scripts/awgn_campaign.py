"""Full AWGN BLER ladder: MCS 0-27 vs the reference's 28-curve corpus.

The reference's principal validation artifact is the AWGN BLER campaign
(openair1/SIMULATION/LTE_PHY/BLER_SIMULATIONS/AWGN/AWGN_results/
bler_tx1_chan18_nrx1_mcs{0..27}.csv, written by dlsim.c:779-780,3821):
5 MHz / 25 PRB SISO, 1 PDCCH symbol (the CSV `rate` column equals TBS/G
only at num_pdcch_symbols=1), estimated channel, round-0 BLER, 0.1 dB SNR
grid, ~5000-10000 trials/point.  This script reruns every curve under the
same conditions (est_mode="interp" = the reference's per-pilot-symbol
estimator analog; snr_convention="dlsim" = the reference's grid-average
noise calibration, dlsim.c:2852) and emits:

  * per-MCS CSV in the reference schema ->  awgn_results/mcs{N}.csv
  * awgn_campaign.json: per-MCS curves + SNR@50%/10%/1% crossings and
    delta-dB vs the reference curve (negative = ours is better).

One subprocess per MCS, one at a time: the parent process never imports
JAX, so each child has the card to itself (one JAX process per card).
Resumable: MCS whose .csv already exists under awgn_results/ are skipped.

Usage:  python scripts/awgn_campaign.py [n_trials] [mcs_list|all]
"""
import json
import os
import subprocess
import sys
import time

sys.path.append(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

REF_DIR = ("/root/reference/openair1/SIMULATION/LTE_PHY/BLER_SIMULATIONS/"
           "AWGN/AWGN_results")
OUT_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "awgn_results")
N_TRIALS = 2048       # base trials/point; tail points get TAIL_TRIALS
TAIL_TRIALS = 8192    # once BLER < TAIL_THRESH, resolve the 1% crossing
TAIL_THRESH = 0.05
GRID_EXTEND_DB = 3.0  # sweep starts below the reference grid: our floats
#   are expected better, so our waterfall sits left of the reference's
STEP_DB = 0.1


def read_ref_curve(mcs: int):
    """-> (snr[], bler0[], tbs, rate) from the reference CSV."""
    snrs, blers = [], []
    tbs = rate = None
    with open(os.path.join(REF_DIR, f"bler_tx1_chan18_nrx1_mcs{mcs}.csv")) as f:
        next(f)  # header
        for line in f:
            parts = line.strip().split(";")
            if len(parts) < 6:
                continue
            snrs.append(float(parts[0]))
            tbs = int(parts[2])
            rate = float(parts[3])
            err0, tr0 = int(parts[4]), int(parts[5])
            blers.append(err0 / max(tr0, 1))
    return np.asarray(snrs), np.asarray(blers), tbs, rate


def crossing(snrs, blers, level):
    """First SNR where the curve falls below `level` (log-linear interp);
    None if it never does within the grid."""
    b = np.maximum(np.asarray(blers, float), 1e-9)
    s = np.asarray(snrs, float)
    below = np.nonzero(b < level)[0]
    if len(below) == 0:
        return None
    i = below[0]
    if i == 0:
        return float(s[0])
    # interpolate in log(BLER)
    l0, l1 = np.log10(b[i - 1]), np.log10(b[i])
    t = (np.log10(level) - l0) / (l1 - l0)
    return float(s[i - 1] + t * (s[i] - s[i - 1]))


def run_one(mcs: int, n_trials: int):
    from openair4g_tpu.sim.dlsim import DlsimFading, DlsimFadingConfig

    ref_snr, ref_bler, ref_tbs, ref_rate = read_ref_curve(mcs)
    cfg = DlsimFadingConfig(
        mcs=mcs, n_rb=25, channel="AWGN", n_pdcch_symbols=1,
        n_rx=1, n_harq_rounds=1, batch=256,
        est_mode="interp", snr_convention="dlsim")
    sim = DlsimFading(cfg)
    tbs = sim.dlsch.cfg.tbs
    G = sim.dlsch.cfg.G
    assert tbs == ref_tbs, (mcs, tbs, ref_tbs)

    start = round(ref_snr[0] - GRID_EXTEND_DB, 1)
    grid = np.round(np.arange(start, ref_snr[-1] + STEP_DB / 2, STEP_DB), 2)
    rows = []          # (snr, err0, trials0, dci_err)
    t_begin = time.time()
    zero_streak = 0
    tail_trials = TAIL_TRIALS if n_trials >= 2048 else n_trials
    for s in grid:
        errs, reach = sim.run_snr(float(s), n_trials)
        e, t, dc = int(errs[0]), int(reach[0]), int(sim.dci_miss)
        if t and e / t < TAIL_THRESH and n_trials < tail_trials:
            errs2, reach2 = sim.run_snr(float(s), tail_trials - n_trials,
                                        seed=1)
            e += int(errs2[0]); t += int(reach2[0])
            dc += int(sim.dci_miss)
        rows.append((float(s), e, t, dc))
        print(f"mcs{mcs} SNR {s:+6.2f}: {e}/{t} = {e/max(t,1):.4f} "
              f"dci_err {dc}", flush=True)
        zero_streak = zero_streak + 1 if e == 0 else 0
        if zero_streak >= 2:
            break
    dt = time.time() - t_begin

    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, f"mcs{mcs}.csv"), "w") as f:
        f.write("SNR; MCS; TBS; rate; err0; trials0; err1; trials1; "
                "err2; trials2; err3; trials3; dci_err\n")
        for s, e, t, dc in rows:
            f.write(f"{s:.6f};{mcs};{tbs};{tbs/G:.6f};{e};{t};"
                    f"0;0;0;0;0;0;{dc}\n")

    snrs = [r[0] for r in rows]
    blers = [r[1] / max(r[2], 1) for r in rows]
    out = {
        "mcs": mcs, "tbs": tbs, "G": G, "rate": tbs / G,
        "est_mode": cfg.est_mode, "snr_convention": cfg.snr_convention,
        "n_turbo_iter": cfg.n_turbo_iter, "seconds": round(dt, 1),
        "snr": snrs, "bler0": blers,
        "ours": {lvl: crossing(snrs, blers, float(lvl))
                 for lvl in ("0.5", "0.1", "0.01")},
        "ref": {lvl: crossing(ref_snr, ref_bler, float(lvl))
                for lvl in ("0.5", "0.1", "0.01")},
    }
    out["delta_db"] = {
        lvl: (None if out["ours"][lvl] is None or out["ref"][lvl] is None
              else round(out["ours"][lvl] - out["ref"][lvl], 3))
        for lvl in ("0.5", "0.1", "0.01")}
    with open(os.path.join(OUT_DIR, f"mcs{mcs}.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(f"mcs{mcs} done in {dt:.0f}s  delta_db={out['delta_db']}",
          flush=True)


def main():
    n_trials = int(sys.argv[1]) if len(sys.argv) > 1 else N_TRIALS
    sel = sys.argv[2] if len(sys.argv) > 2 else "all"
    if sel != "all" and "," not in sel and sel.isdigit() and len(sys.argv) > 3:
        pass
    if len(sys.argv) > 3 and sys.argv[3] == "--worker":
        run_one(int(sel), n_trials)
        return
    mcss = (list(range(28)) if sel == "all"
            else [int(x) for x in sel.split(",")])
    for mcs in mcss:
        if os.path.exists(os.path.join(OUT_DIR, f"mcs{mcs}.json")):
            print(f"mcs{mcs}: exists, skipping", flush=True)
            continue
        r = subprocess.run([sys.executable, __file__, str(n_trials),
                            str(mcs), "--worker"])
        if r.returncode != 0:
            print(f"mcs{mcs}: FAILED rc={r.returncode}", flush=True)
    # aggregate
    agg = {}
    for mcs in range(28):
        p = os.path.join(OUT_DIR, f"mcs{mcs}.json")
        if os.path.exists(p):
            with open(p) as f:
                agg[f"mcs{mcs}"] = json.load(f)
    root = os.path.dirname(OUT_DIR)
    with open(os.path.join(root, "awgn_campaign.json"), "w") as f:
        json.dump(agg, f, indent=1)
    print(f"wrote awgn_campaign.json ({len(agg)}/28 curves)", flush=True)


if __name__ == "__main__":
    main()
