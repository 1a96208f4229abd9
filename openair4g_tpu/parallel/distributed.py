"""Multi-host BLER sweeps over the network: jax.distributed + global mesh.

Reference parity: distributed oaisim (`-M`) — eNB/UE instances sharded
across machines exchanging per-frame buffers over IP multicast /
OpenPGM (SIMULATION/ETH_TRANSPORT/{emu_transport.c, multicast_link.c,
pgm_link.c}; master/worker frame barriers), and launch_sim.sh's PBS
cluster sweeps. Here every process contributes its local devices to ONE
global mesh (jax.distributed), the Monte-Carlo trial batch is sharded
over the mesh's "ue" axis (jax.make_array_from_process_local_data builds
the global batch from per-process key slices), and the error
accumulators psum across devices (NVLink within a host, the network
across hosts) — the collective replaces the multicast transport, the
runtime's heartbeat replaces the frame barrier.

Determinism: trial keys derive from (seed, global trial index) on the
host, so the N-host sweep is bit-identical to the 1-host sweep with the
same total batch (SURVEY.md §4's multi-host test requirement).

Checkpoint/resume: sweep progress (per-SNR accumulators + stream index)
persists through sim/harness.py's SweepState on process 0; a preempted
multi-host job resumes at the last finished chunk (SURVEY.md §5).

Single-process use (tests, one host) needs no coordinator: call
`distributed_bler_sweep` directly — the global mesh is just the local
devices. Multi-process use:

    # in every process h of H:
    python -m openair4g_tpu.parallel.distributed \
        --coordinator host0:1234 --nprocs H --proc-id h \
        --mcs 4 --n-rb 25 --snrs -2:2:0.5 --frames 10000

A JAX process reserves most of a GPU's memory when it starts, so a
second process on the same card fails. Run one process per card (each
with its own CUDA_VISIBLE_DEVICES), or pass `--platform cpu` to every
process, as the localhost multi-process tests do.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P, NamedSharding
from jax import shard_map

from ..utils.rng import host_keys


def init_multihost(coordinator: str | None, nprocs: int, proc_id: int):
    """jax.distributed bring-up. No-op for single-process runs."""
    if nprocs > 1:
        jax.distributed.initialize(coordinator_address=coordinator,
                                   num_processes=nprocs,
                                   process_id=proc_id)


def global_mesh(axis: str = "ue") -> Mesh:
    """One mesh over every chip of every participating host."""
    return Mesh(np.asarray(jax.devices()), (axis,))


class DistributedSweep:
    """Globally-sharded Monte-Carlo accumulator.

    step_fn(keys [b, 2], n0) -> ok [b] bool (or a tuple whose first
    element is ok) — any per-trial link sim step (dlsim/ulsim/fullsim).
    Each process feeds only its local share of the global key batch;
    the psum'd error count is identical on every process.
    """

    def __init__(self, step_fn, mesh: Mesh | None = None,
                 batch_per_device: int = 32, axis: str = "ue"):
        self.mesh = mesh or global_mesh(axis)
        self.axis = axis
        self.bpd = batch_per_device
        self.n_global = self.mesh.shape[axis]
        self.batch = self.bpd * self.n_global
        self.spec = NamedSharding(self.mesh, P(axis))

        def sharded(keys, n0):
            ok = step_fn(keys, n0)
            if isinstance(ok, tuple):
                ok = ok[0]
            return jax.lax.psum(jnp.sum(~ok).astype(jnp.int32), axis)

        self._step = jax.jit(shard_map(
            sharded, mesh=self.mesh, in_specs=(P(axis), P()),
            out_specs=P(), check_vma=False))

    def _global_keys(self, seed: int, stream: int):
        """Build the globally-sharded key batch from per-process slices.

        Keys are indexed by GLOBAL trial id, so every process computes
        the same logical batch and contributes its addressable slice —
        the jax.make_array_from_process_local_data path when running
        multi-process, a plain device_put single-process."""
        all_keys = host_keys(seed, self.batch, stream=stream)
        if jax.process_count() == 1:
            return jax.device_put(all_keys, self.spec)
        per = self.batch // jax.process_count()
        lo = jax.process_index() * per
        return jax.make_array_from_process_local_data(
            self.spec, all_keys[lo:lo + per], all_keys.shape)

    def run_snr(self, snr_db: float, n_frames: int, seed: int = 0,
                stream0: int = 0):
        n0 = jnp.float32(10.0 ** (-snr_db / 10.0))
        errs = trials = 0
        n_chunks = -(-n_frames // self.batch)
        for i in range(n_chunks):
            keys = self._global_keys(seed, stream0 + i)
            errs += int(self._step(keys, n0))
            trials += self.batch
        return errs, trials, stream0 + n_chunks


def distributed_bler_sweep(sim_factory, snrs, n_frames: int,
                           mesh: Mesh | None = None,
                           batch_per_device: int = 32, seed: int = 0,
                           ckpt_path: str | None = None,
                           verbose: bool = True):
    """Full sweep: sim_factory() -> object with `.trial_ok(keys, n0)`
    (a [b]-batched single-round link-sim step). Returns rows of
    (snr, errs, trials). Process 0 owns the checkpoint file."""
    from ..sim.harness import SweepState
    sim = sim_factory()
    sweep = DistributedSweep(sim.trial_ok, mesh=mesh,
                             batch_per_device=batch_per_device)
    state = None
    if ckpt_path and jax.process_index() == 0:
        state = SweepState.load(ckpt_path, config=dict(
            kind="distributed", seed=seed, batch=sweep.batch,
            snrs=[float(s) for s in snrs], n_frames=n_frames))
    rows = []
    for s in snrs:
        errs0 = trials0 = stream0 = 0
        if state is not None and state.get(float(s)) is not None:
            pt = state.get(float(s))
            errs0 = pt["errs"][0]
            trials0 = pt["trials"][0]
            stream0 = pt["streams"]
        remaining = n_frames - trials0
        if remaining > 0:
            e, t, next_stream = sweep.run_snr(float(s), remaining,
                                              seed=seed, stream0=stream0)
            errs0 += e
            trials0 += t
            if state is not None:
                state.update(float(s), errs0, trials0, next_stream)
                state.save(ckpt_path)
        rows.append((float(s), errs0, trials0))
        if verbose and jax.process_index() == 0:
            print(f"SNR {s:+6.2f} dB: bler {errs0 / max(trials0, 1):.4f} "
                  f"({errs0}/{trials0}) on {sweep.n_global} devices x "
                  f"{jax.process_count()} hosts", flush=True)
        if errs0 == 0:
            break
    return rows


def _parse_snrs(spec: str):
    lo, hi, step = (float(x) for x in spec.split(":"))
    return np.arange(lo, hi + 1e-9, step)


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser(description="multi-host AWGN dlsim sweep")
    p.add_argument("--coordinator", default=None)
    p.add_argument("--nprocs", type=int, default=1)
    p.add_argument("--proc-id", type=int, default=0)
    p.add_argument("--mcs", type=int, default=4)
    p.add_argument("--n-rb", type=int, default=25)
    p.add_argument("--snrs", default="-4:4:1.0")
    p.add_argument("--frames", type=int, default=1024)
    p.add_argument("--batch-per-device", type=int, default=32)
    p.add_argument("--ckpt", default=None)
    p.add_argument("--platform", default=None,
                   help="force a JAX platform (e.g. cpu) before init — "
                   "for localhost multi-process runs that must not share "
                   "one GPU (one JAX process per card)")
    p.add_argument("--host-devices", type=int, default=0,
                   help="with --platform cpu: virtual device count per "
                   "process (xla_force_host_platform_device_count)")
    p.add_argument("--out", default=None,
                   help="process 0 writes rows as JSON here")
    a = p.parse_args(argv)
    if a.host_devices:
        import os
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={a.host_devices}"
        ).strip()
    if a.platform:
        jax.config.update("jax_platforms", a.platform)
    init_multihost(a.coordinator, a.nprocs, a.proc_id)

    def factory():
        from ..sim.dlsim import DlsimAwgn, DlsimConfig
        sim = DlsimAwgn(DlsimConfig(mcs=a.mcs, n_rb=a.n_rb))
        sim.trial_ok = sim._trial_step      # [b] ok + per-trial extras
        return sim

    rows = distributed_bler_sweep(factory, _parse_snrs(a.snrs), a.frames,
                                  batch_per_device=a.batch_per_device,
                                  ckpt_path=a.ckpt)
    if a.out and jax.process_index() == 0:
        import json
        with open(a.out, "w") as f:
            json.dump(rows, f)
    return rows


if __name__ == "__main__":
    main()
