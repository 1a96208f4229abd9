"""Time the turbo decoder's options on the attached GPU.

    python scripts/decoder_sweep.py half           # one half-iteration
    python scripts/decoder_sweep.py llr            # MRC+LLR fused vs 2-stage
    python scripts/decoder_sweep.py flagship S1 S2 ...
    python scripts/decoder_sweep.py bler S1 S2 ... [--steps N --snr DB]

A setting S is half_iter:window:warmup:unroll:lanes, e.g.
`triton:64:24:8:128` or `xla:240:24:8:0`. `flagship` runs the
20 MHz MCS26 EVA joint-CE round-0 step (batch 128, 8 iterations, 24 dB;
the bench flagship) once per setting to compile, then times the settings
in turns, forwards then backwards, so that drift hits all alike. Every
time is a host clock around work that ends in block_until_ready. Each
line names the device and the card's power limit. `bler` counts TB
errors and DCI misses of the same flagship step over N batches of
trials, with the same keys for every setting.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from chip_smoke import card_line, require_gpu  # noqa: E402
from openair4g_tpu.ops import decoder_settings as ds  # noqa: E402
from openair4g_tpu.ops import turbo, turbo_pallas  # noqa: E402
from openair4g_tpu.utils import kernel_checks as kc  # noqa: E402


def timed(fn, *args, reps: int = 20):
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)), float(np.min(ts)), float(np.max(ts))


def fmt(t):
    return f"median {t[0] * 1e3:.4f} ms (min {t[1] * 1e3:.4f}, " \
           f"max {t[2] * 1e3:.4f})"


def parse(spec: str):
    f = spec.split(":")
    return ds.DecoderSettings(window=int(f[1]), warmup=int(f[2]),
                              unroll=int(f[3]), half_iter=f[0],
                              lanes=int(f[4]) or 128)


def cmd_half(card, args):
    for spec in args.settings or ["xla:64:24:8:0", "xla:240:24:8:0",
                                  "triton:32:24:1:128", "triton:64:24:1:64",
                                  "triton:64:24:1:128", "triton:64:24:1:256",
                                  "triton:128:24:1:128", "triton:64:32:1:128"]:
        s = parse(spec)
        W, U = s.window, s.warmup
        lin, lp = kc._flagship_llrs(W)
        if s.half_iter == "xla":
            fn = jax.jit(lambda a, b: turbo._half_iteration(a, b, W, U,
                                                            s.unroll))
        else:
            fn = jax.jit(lambda a, b: turbo_pallas.half_iteration(
                a, turbo_pallas.prep_parity(b, W, U, s.lanes), W, U,
                s.lanes))
        print(f"half {spec}: [{kc.FLAGSHIP_BLOCKS}, {lin.shape[1]}] "
              f"{fmt(timed(fn, lin, lp))} [{card}]", flush=True)


def cmd_llr(card, args):
    from openair4g_tpu.ops.equalize_llr import mrc_llr
    from openair4g_tpu.ops.llr import demap_llr
    from openair4g_tpu.phy.equalize import mrc_equalize
    B, R = 128, kc.FLAGSHIP_DATA_RE
    ks = jax.random.split(jax.random.PRNGKey(1), 4)
    y = (jax.random.normal(ks[0], (B, R, 1))
         + 1j * jax.random.normal(ks[1], (B, R, 1))).astype(jnp.complex64)
    H = (jax.random.normal(ks[2], (B, R, 1))
         + 1j * jax.random.normal(ks[3], (B, R, 1))).astype(jnp.complex64)
    n0 = jnp.full((B, R), 0.3, jnp.float32)
    for name, f in (
            ("fused closed form", lambda y, H, n: mrc_llr(y, H, n, 6)),
            ("two-stage", lambda y, H, n: demap_llr(*mrc_equalize(y, H, n),
                                                    6))):
        fn = jax.jit(f)
        hlo = fn.lower(y, H, n0).compile().as_text()
        entry = hlo[hlo.index("ENTRY"):]
        n_fusion = sum(1 for line in entry.splitlines()
                       if " fusion(" in line or "custom-call(" in line)
        print(f"llr {name}: [{B}, {R}] 64QAM {fmt(timed(fn, y, H, n0))}; "
              f"{n_fusion} fusions/custom calls in the entry computation "
              f"[{card}]", flush=True)


def cmd_flagship(card, args):
    batch = args.batch
    steps = {}
    for spec in args.settings:
        step = _flagship_step(spec, batch, args.snr)
        t0 = time.perf_counter()
        ok, _, _, dci_ok = step(0)
        print(f"flagship {spec}: compile+first {time.perf_counter() - t0:.3f}"
              f" s, tb_err {int(np.sum(~np.asarray(ok)))}/{batch} dci_miss "
              f"{int(np.sum(~np.asarray(dci_ok)))}/{batch}", flush=True)
        steps[spec] = step
    times = {spec: [] for spec in steps}
    order = list(steps)
    for r in range(args.rounds):
        for spec in (order if r % 2 == 0 else order[::-1]):
            for i in range(args.reps):
                t0 = time.perf_counter()
                steps[spec](1 + i)
                times[spec].append(time.perf_counter() - t0)
    for spec, ts in times.items():
        t = (float(np.median(ts)), min(ts), max(ts))
        print(f"flagship {spec}: batch {batch} step {fmt(t)}, "
              f"{batch / t[0]:.1f} subframes/s over {len(ts)} steps "
              f"[{card}]", flush=True)
    stats = jax.devices()[0].memory_stats() or {}
    print(f"flagship: peak_bytes_in_use {stats.get('peak_bytes_in_use')} "
          f"[{card}]", flush=True)


def _flagship_step(spec, batch, snr):
    from openair4g_tpu.sim.dlsim import DlsimFading, DlsimFadingConfig
    from openair4g_tpu.utils.rng import host_keys
    ds.DECODER_SETTINGS["gpu"] = parse(spec)
    sim = DlsimFading(DlsimFadingConfig(
        mcs=26, n_rb=100, channel="EVA", n_rx=1, n_harq_rounds=1,
        batch=batch, est_mode="joint", n_turbo_iter=8))
    n0 = jnp.float32(10.0 ** (-snr / 10.0))
    W, ev, rnd0 = sim.wiener(snr), sim.err_var(snr), sim._round(0)

    def step(i):
        d, k_ch, k_n = sim._tx(jnp.asarray(host_keys(0, batch, stream=i)))
        return jax.block_until_ready(rnd0(d, k_ch[0], k_n[0], n0, W, ev))
    return step


def cmd_bler(card, args):
    for spec in args.settings:
        step = _flagship_step(spec, args.batch, args.snr)
        tb_err = dci_miss = 0
        for i in range(args.steps):
            ok, _, _, dci_ok = step(i)
            tb_err += int(np.sum(~np.asarray(ok)))
            dci_miss += int(np.sum(~np.asarray(dci_ok)))
        n = args.steps * args.batch
        print(f"bler {spec} @ {args.snr} dB: tb_err {tb_err}/{n} dci_miss "
              f"{dci_miss}/{n} [{card}]", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("what", choices=["half", "llr", "flagship", "bler"])
    ap.add_argument("settings", nargs="*")
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--snr", type=float, default=24.0)
    args = ap.parse_args()
    dev = require_gpu(1)[0]
    from openair4g_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    card = f"{dev.device_kind}; {card_line()}"
    globals()[f"cmd_{args.what}"](card, args)


if __name__ == "__main__":
    main()
