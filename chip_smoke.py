"""Smoke test of the LTE baseband on one NVIDIA GPU (or four with --four).

    python chip_smoke.py           # every phase, one card
    python chip_smoke.py --four    # only the four-card data-parallel path

Phases (one card), each printing one line of numbers:

  device    the JAX platform must be "gpu"; device kind, card name and
            power limit
  flagship  the 20 MHz bench flagship (100 PRB, PDSCH MCS 26, EVA,
            joint-LMMSE CE, format-1A PDCCH blind decode, 8 turbo
            iterations, batch 128) through sim/dlsim.py. At the bench's
            24 dB: compile time, steady step time, peak device memory;
            every DCI decodes, and the TB errors stay under 2% (EVA
            fading leaves ~0.6% of 1-Rx subframes in outage there on
            every decoder route). At 27 dB every TB and DCI decodes.
  per-TTI   one 20 MHz subframe eNB TX (sched/enb_tx.py) -> AWGN ->
            UE RX (sched/ue_rx.py UeRx.receive)
  uplink    a 25-PRB PUSCH point through sim/ulsim.py above its knee
  fidelity  two BLER anchors of tests/test_bler_anchor.py at their
            test bounds
  kernels   each kernel against its plain reference at flagship widths,
            then the tests marked `gpu`, in this process

The last line is {"ok": true, "device": {...}}. A phase that fails prints
its traceback; the remaining phases still run, then the script exits
non-zero without that line. With no GPU it exits before the first phase.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np
import jax
import jax.numpy as jnp

REPO = os.path.dirname(os.path.abspath(__file__))
SNR_FLAGSHIP_DB = 24.0
SNR_CLEAN_DB = 27.0            # above the EVA outage of MCS 26 with 1 Rx


def card_line() -> str:
    """`name, power limit` of every card, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return "; ".join(line.strip() for line in out.splitlines() if line)


def require_gpu(count: int) -> list:
    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(f"chip_smoke: no GPU: JAX's devices are "
                 f"{[d.platform for d in devs]}")
    if len(devs) < count:
        sys.exit(f"chip_smoke: needs {count} GPUs, JAX sees {len(devs)}")
    return devs


# --------------------------------------------------------------- phases --

def phase_flagship(card: str, batch: int = 128, n_turbo_iter: int = 8,
                   n_steps: int = 5, n_rb: int = 100, mcs: int = 26):
    from openair4g_tpu.sim.dlsim import DlsimFading, DlsimFadingConfig
    from openair4g_tpu.utils.rng import host_keys

    sim = DlsimFading(DlsimFadingConfig(
        mcs=mcs, n_rb=n_rb, channel="EVA", n_rx=1, n_harq_rounds=1,
        batch=batch, est_mode="joint", n_turbo_iter=n_turbo_iter))
    rnd0 = sim._round(0)
    # the Wiener matrix and the error variance are host numpy work per
    # SNR (bench.py too builds them once): kept out of the timed steps
    per_snr = {snr: (jnp.float32(10.0 ** (-snr / 10.0)), sim.wiener(snr),
                     sim.err_var(snr))
               for snr in (SNR_FLAGSHIP_DB, SNR_CLEAN_DB)}

    def step(i, snr=SNR_FLAGSHIP_DB):
        d, kc, kn = sim._tx(jnp.asarray(host_keys(0, batch, stream=i)))
        ok, _, _, dci_ok = rnd0(d, kc[0], kn[0], *per_snr[snr])
        return jax.block_until_ready((ok, dci_ok))

    def errors(outs):
        return (sum(int(np.sum(~np.asarray(ok))) for ok, _ in outs),
                sum(int(np.sum(~np.asarray(d))) for _, d in outs))

    t0 = time.perf_counter()
    outs = [step(0)]
    compile_s = time.perf_counter() - t0
    times = []
    for i in range(1, n_steps + 1):
        t0 = time.perf_counter()
        outs.append(step(i))
        times.append(time.perf_counter() - t0)
    tb_err, dci_miss = errors(outs)
    n = batch * len(outs)
    clean = [step(100 + i, SNR_CLEAN_DB) for i in range(2)]
    tb_clean, dci_clean = errors(clean)
    n_clean = batch * len(clean)
    step_s = float(np.median(times))
    stats = jax.devices()[0].memory_stats() or {}
    print(f"flagship: {n_rb} PRB MCS{mcs} EVA joint-CE {n_turbo_iter} it "
          f"batch {batch} @ {SNR_FLAGSHIP_DB} dB: tb_err {tb_err}/{n} "
          f"dci_miss {dci_miss}/{n}; compile+first step {compile_s:.3f} s, "
          f"steady step median {step_s * 1e3:.3f} ms "
          f"(min {min(times) * 1e3:.3f}, max {max(times) * 1e3:.3f}; "
          f"{batch / step_s:.1f} subframes/s), peak memory "
          f"{stats.get('peak_bytes_in_use', 'n/a')} B; @ {SNR_CLEAN_DB} dB: "
          f"tb_err {tb_clean}/{n_clean} dci_miss {dci_clean}/{n_clean} "
          f"[{card}]", flush=True)
    assert dci_miss == 0 and tb_err <= 0.02 * n, (tb_err, dci_miss)
    assert tb_clean == 0 and dci_clean == 0, (tb_clean, dci_clean)


def phase_per_tti(card: str, n_rb: int = 100, mcs: int = 26, batch: int = 8,
                  snr_db: float = 30.0):
    from openair4g_tpu.sched.enb_tx import CellConfig, EnbTx
    from openair4g_tpu.sched.ue_rx import UeRx
    from openair4g_tpu.ops.gold import scramble_bits
    from openair4g_tpu.ops.llr import map_symbols
    from openair4g_tpu.phy import ofdm

    cell = CellConfig(n_rb=n_rb, n_pdcch=1, n_prb=n_rb, mcs=mcs)
    enb = EnbTx(cell)
    ue = UeRx(cell)
    k_tb, k_ack, k_noise = jax.random.split(jax.random.PRNGKey(7), 3)
    tb = jax.random.bernoulli(k_tb, 0.5, (batch, ue.codec.cfg.tbs)
                              ).astype(jnp.int32)
    ack = jax.random.bernoulli(k_ack, 0.5, (batch,)).astype(jnp.int32)
    n0 = 10.0 ** (-snr_db / 10.0)
    wiener = jnp.asarray(ue.make_wiener(n0))

    @jax.jit
    def tti(tb, ack, key):
        e = scramble_bits(ue.codec.encode(tb), ue.scr_seq)
        sym = map_symbols(e, ue.codec.cfg.Qm).astype(jnp.complex64)
        tx = enb.data_waveform(sym, ack_bits=ack)
        nr = jax.random.normal(key, tx.shape + (2,))
        rx = tx + jnp.sqrt(n0 / 2) * (nr[..., 0] + 1j * nr[..., 1])
        return ue.receive(ofdm.ofdm_demodulate(rx, enb.fp),
                          jnp.float32(n0), wiener)

    t0 = time.perf_counter()
    out = jax.block_until_ready(tti(tb, ack, k_noise))
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    jax.block_until_ready(tti(tb, ack, k_noise))
    step_s = time.perf_counter() - t0
    cfi_ok = int(np.sum(np.asarray(out["cfi_hat"]) == cell.n_pdcch))
    dci_ok = int(np.sum(np.asarray(out["dci_found"])))
    tb_ok = int(np.sum(np.asarray(out["tb_ok"])))
    bits_ok = bool(np.array_equal(np.asarray(out["tb"]), np.asarray(tb)))
    phich_ok = int(np.sum(np.asarray(out["phich_ack"])
                          == np.asarray(ack, bool)))
    print(f"per-TTI: EnbTx -> AWGN {snr_db} dB -> UeRx.receive, {n_rb} PRB "
          f"MCS{mcs} batch {batch}: cfi {cfi_ok}/{batch} dci {dci_ok}/{batch} "
          f"tb {tb_ok}/{batch} bits_equal {bits_ok} phich {phich_ok}/{batch}; "
          f"compile+first {first_s:.3f} s, step {step_s * 1e3:.3f} ms "
          f"[{card}]", flush=True)
    assert cfi_ok == dci_ok == tb_ok == phich_ok == batch and bits_ok


def phase_uplink(card: str, n_trials: int = 256):
    from openair4g_tpu.sim.ulsim import Ulsim, UlsimConfig

    mcs, snr = 16, 8.3        # test_ul_ladder_anchor's above-knee point
    sim = Ulsim(UlsimConfig(mcs=mcs, n_rb=25, n_rb_alloc=25, channel="AWGN",
                            batch=128))
    t0 = time.perf_counter()
    errs, reach = sim.run_snr(snr, n_trials)
    dt = time.perf_counter() - t0
    print(f"uplink: ulsim 25 PRB MCS{mcs} AWGN @ {snr} dB: "
          f"errs {int(errs[0])}/{int(reach[0])} (bound <= 0.13), "
          f"{dt:.3f} s incl. compile [{card}]", flush=True)
    assert errs[0] <= reach[0] * 0.13, (errs, reach)


def _knee(sim, points, n_trials):
    rows = []
    for snr, lo, hi in points:
        errs, reach = sim.run_snr(snr, n_trials)
        e, r = int(errs[0]), int(reach[0])
        rows.append((snr, e, r, lo * r <= e <= hi * r))
    return rows


def phase_fidelity(card: str, n_trials: int = 256):
    from openair4g_tpu.sim.dlsim import DlsimFading, DlsimFadingConfig

    # test_mcs4_estimated_ce_waterfall_location
    sim = DlsimFading(DlsimFadingConfig(mcs=4, n_rb=25, channel="AWGN",
                                        batch=128, n_turbo_iter=8,
                                        n_harq_rounds=1))
    mcs4 = _knee(sim, [(-2.6, 0.9, 1.0), (-1.8, 0.2, 0.8), (-1.0, 0.0, 0.1)],
                 n_trials)
    # the MCS 9 row of test_awgn_ladder_anchor
    sim = DlsimFading(DlsimFadingConfig(
        mcs=9, n_rb=25, channel="AWGN", n_pdcch_symbols=1, n_rx=1,
        n_harq_rounds=1, batch=128, est_mode="interp",
        snr_convention="dlsim"))
    mcs9 = _knee(sim, [(1.7, 0.8, 1.0), (2.0, 0.15, 0.85), (2.3, 0.0, 0.12)],
                 n_trials)
    for name, rows in (("mcs4 est-CE waterfall", mcs4),
                       ("mcs9 AWGN ladder", mcs9)):
        txt = ", ".join(f"{s:+.1f} dB {e}/{r}{'' if ok else ' OUT'}"
                        for s, e, r, ok in rows)
        print(f"fidelity: {name}: {txt} [{card}]", flush=True)
    assert all(ok for *_, ok in mcs4 + mcs9), (mcs4, mcs9)


def phase_kernels(card: str):
    from openair4g_tpu.utils.kernel_checks import (turbo_kernel_check,
                                                   mrc_llr_check)
    for check in (turbo_kernel_check, mrc_llr_check):
        r = check()
        print(f"kernels: {r['name']}: max abs err {r['max_abs_err']:.3e} "
              f"(tolerance {r['tol']:.1e}, {r['precision']}) at "
              f"{r['shape']} [{card}]", flush=True)
        assert r["max_abs_err"] <= r["tol"], r
    run_gpu_tests()


def run_gpu_tests():
    """The tests marked `gpu`, here in this process (their fixture sees
    this process's GPU). --noconftest: tests/conftest.py pins the CPU."""
    import pytest

    class Count:
        passed = failed = 0

        def pytest_runtest_logreport(self, report):
            if report.when == "call":
                self.passed += report.passed
                self.failed += report.failed

    counter = Count()
    rc = pytest.main(["-q", "--noconftest", "-p", "no:cacheprovider",
                      "-m", "gpu",
                      os.path.join(REPO, "tests", "test_gpu_kernels.py")],
                     plugins=[counter])
    print(f"kernels: gpu-marked tests: {counter.passed} passed, "
          f"{counter.failed} failed, pytest exit {int(rc)}", flush=True)
    assert int(rc) == 0 and counter.passed > 0 and counter.failed == 0


def phase_four(card: str, batch_per_device: int = 32, n_turbo_iter: int = 8):
    sys.path.insert(0, REPO)
    import __graft_entry__ as g

    n = 4
    t0 = time.perf_counter()
    errs4, miss4, trials = g.make_flagship_sharded(
        n, batch_per_device, n_turbo_iter, SNR_FLAGSHIP_DB)()
    dt4 = time.perf_counter() - t0
    t0 = time.perf_counter()
    errs1, miss1, _ = g.flagship_one_device(trials, n_turbo_iter,
                                            SNR_FLAGSHIP_DB)
    dt1 = time.perf_counter() - t0
    print(f"four: flagship sharded over ('ue',) x {n}: tb_err {errs4} "
          f"dci_miss {miss4} of {trials} ({dt4:.3f} s incl. compile); one "
          f"card, same keys: tb_err {errs1} dci_miss {miss1} ({dt1:.3f} s "
          f"incl. compile) [{card}]", flush=True)
    assert (errs4, miss4) == (errs1, miss1)
    pos = g.pss_halo_check(n_ue=2, n_t=2)
    print(f"four: PSS halo on a (ue=2, t=2) mesh: peaks {pos} [{card}]",
          flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card data-parallel path")
    args = ap.parse_args(argv)
    count = 4 if args.four else 1
    devs = require_gpu(count)

    sys.path.insert(0, REPO)
    from openair4g_tpu.utils.compile_cache import enable_compile_cache
    cache = enable_compile_cache()
    card = card_line()
    print(f"device: platform {devs[0].platform}, kind {devs[0].device_kind}, "
          f"count {len(devs)}, jax {jax.__version__}, compile cache {cache}",
          flush=True)
    print(f"card: {card}", flush=True)
    phases = ([phase_four] if args.four else
              [phase_flagship, phase_per_tti, phase_uplink, phase_fidelity,
               phase_kernels])
    failed = []
    for phase in phases:
        try:
            phase(card)
        except Exception:
            traceback.print_exc()
            failed.append(phase.__name__)
    if failed:
        print(f"chip_smoke: FAILED phases {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
