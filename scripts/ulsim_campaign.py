"""UL fidelity campaign: a PUSCH BLER mini-ladder + fading points.

Brings the uplink to the DL ladder's evidence standard (VERDICT r4
missing #5): the reference treats ulsim as a first-class harness
(openair1/SIMULATION/LTE_PHY/ulsim.c:163) but ships no UL BLER corpus,
so these are measured curves in the same CSV schema as the DL ladder:

  * AWGN ladder, 25 PRB full allocation, estimated (DMRS) CE,
    MCS {4, 10, 16, 20, 23}: QPSK / 16QAM / (UL)64QAM-capable rows
    across TBS sizes  ->  ulsim_results/mcs{N}.csv
  * 2 fading points through the TIME-FIR sample-stream channel path
    (the reference's multipath_channel, ulsim.c:1202): EVA and ETU70
    at MCS 10.

Emits ulsim_campaign.json with SNR@50/10/1% crossings per curve.
One subprocess per config, one at a time: the parent process never
imports JAX, so each child has the card to itself (one JAX process per
card). Resumable: configs whose .json exists are skipped.

Usage:  python scripts/ulsim_campaign.py [n_trials] [sel|all]
"""
import json
import os
import subprocess
import sys
import time

sys.path.append(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

OUT_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "ulsim_results")
N_TRIALS = 2048
TAIL_TRIALS = 8192
TAIL_THRESH = 0.05
STEP_DB = 0.25

LADDER_MCS = (4, 10, 16, 20, 23)
# mcs -> sweep start (dB); QPSK from -8, 16QAM from 0, 64-QAM-ish later
START_DB = {4: -8.0, 10: -2.0, 16: 4.0, 20: 8.0, 23: 12.0}
FADING = (("eva", "EVA", 10, 0.0), ("etu70", "ETU", 10, 0.0))


def crossing(snrs, blers, level):
    b = np.maximum(np.asarray(blers, float), 1e-9)
    s = np.asarray(snrs, float)
    below = np.nonzero(b < level)[0]
    if len(below) == 0:
        return None
    i = below[0]
    if i == 0:
        return float(s[0])
    l0, l1 = np.log10(b[i - 1]), np.log10(b[i])
    t = (np.log10(level) - l0) / (l1 - l0)
    return float(s[i - 1] + t * (s[i] - s[i - 1]))


def run_curve(tag: str, cfg, start_db: float, n_trials: int,
              stop_db: float = 40.0):
    from openair4g_tpu.sim.ulsim import Ulsim
    sim = Ulsim(cfg)
    tbs = sim.ulsch.tbs
    rows = []
    t0 = time.time()
    zero_streak = 0
    s = start_db
    while s <= stop_db:
        errs, reach = sim.run_snr(float(s), n_trials)
        e, t = int(errs[0]), int(reach[0])
        if t and e / t < TAIL_THRESH and 1024 <= n_trials < TAIL_TRIALS:
            e2, t2 = sim.run_snr(float(s), TAIL_TRIALS - n_trials, seed=1)
            e += int(e2[0]); t += int(t2[0])
        rows.append((float(s), e, t))
        print(f"{tag} SNR {s:+6.2f}: {e}/{t} = {e/max(t,1):.4f}",
              flush=True)
        zero_streak = zero_streak + 1 if e == 0 else 0
        if zero_streak >= 2:
            break
        s = round(s + STEP_DB, 2)
    dt = time.time() - t0

    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, f"{tag}.csv"), "w") as f:
        f.write("SNR; MCS; TBS; rate; err0; trials0; err1; trials1; "
                "err2; trials2; err3; trials3; dci_err\n")
        for s_, e, t in rows:
            f.write(f"{s_:.6f};{cfg.mcs};{tbs};0;{e};{t};0;0;0;0;0;0;0\n")
    snrs = [r[0] for r in rows]
    blers = [r[1] / max(r[2], 1) for r in rows]
    out = {
        "tag": tag, "mcs": cfg.mcs, "tbs": tbs,
        "channel": cfg.channel,
        "time_domain_channel": cfg.time_domain_channel,
        "n_rb": cfg.n_rb, "n_rb_alloc": cfg.n_rb_alloc,
        "seconds": round(dt, 1), "snr": snrs, "bler0": blers,
        "crossings": {lvl: crossing(snrs, blers, float(lvl))
                      for lvl in ("0.5", "0.1", "0.01")},
    }
    with open(os.path.join(OUT_DIR, f"{tag}.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(f"{tag} done in {dt:.0f}s crossings={out['crossings']}",
          flush=True)


def make_cfg(tag: str):
    from openair4g_tpu.sim.ulsim import UlsimConfig
    if tag.startswith("awgn"):
        mcs = int(tag[4:])
        return UlsimConfig(mcs=mcs, n_rb=25, n_rb_alloc=25,
                           channel="AWGN", batch=256), START_DB[mcs]
    for t, chan, mcs, extra in FADING:
        if tag == t:
            return UlsimConfig(mcs=mcs, n_rb=25, n_rb_alloc=25,
                               channel=chan, batch=256,
                               time_domain_channel=True), 2.0
    raise ValueError(tag)


def all_tags():
    return [f"awgn{m}" for m in LADDER_MCS] + [t for t, *_ in FADING]


def main():
    n_trials = int(sys.argv[1]) if len(sys.argv) > 1 else N_TRIALS
    sel = sys.argv[2] if len(sys.argv) > 2 else "all"
    if len(sys.argv) > 3 and sys.argv[3] == "--worker":
        cfg, start = make_cfg(sel)
        run_curve(sel, cfg, start, n_trials)
        return
    tags = all_tags() if sel == "all" else sel.split(",")
    for tag in tags:
        if os.path.exists(os.path.join(OUT_DIR, f"{tag}.json")):
            print(f"{tag}: exists, skipping", flush=True)
            continue
        r = subprocess.run([sys.executable, __file__, str(n_trials),
                            tag, "--worker"])
        if r.returncode != 0:
            print(f"{tag}: FAILED rc={r.returncode}", flush=True)
    agg = {}
    for tag in all_tags():
        p = os.path.join(OUT_DIR, f"{tag}.json")
        if os.path.exists(p):
            with open(p) as f:
                agg[tag] = json.load(f)
    root = os.path.dirname(OUT_DIR)
    with open(os.path.join(root, "ulsim_campaign.json"), "w") as f:
        json.dump(agg, f, indent=1)
    print(f"wrote ulsim_campaign.json ({len(agg)}/{len(all_tags())})",
          flush=True)


if __name__ == "__main__":
    main()
