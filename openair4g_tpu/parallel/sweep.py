"""Data-parallel BLER sweep over a device mesh (shard_map + psum).

Reference parity: distributed oaisim/dlsim — the reference shards eNB/UE
instances across machines over IP multicast and aggregates frame statistics
at the master (SIMULATION/ETH_TRANSPORT/emu_transport.c, multicast_link.c;
launch_sim.sh PBS sweeps). Here the Monte-Carlo trial batch is sharded over
the mesh's "ue" axis and the error/trial accumulators are reduced with
`psum` over the device interconnect — the collective replaces the multicast ethernet.

Determinism: trial keys are host-constructed (utils/rng.py) from
(seed, global trial index), so the sharded run is bit-identical to the
single-device run for the same total batch — the multi-host test strategy
required by SURVEY.md §4.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P, NamedSharding
from jax import shard_map

from ..utils.rng import host_keys


class ShardedSweep:
    """Wraps a per-trial step `step(keys [b,2], n0) -> ok [b] bool`
    (plus optional extra per-trial outputs) into a mesh-sharded accumulator
    returning globally-reduced (n_err, n_trials)."""

    def __init__(self, step_fn, mesh: Mesh, batch_per_device: int):
        self.mesh = mesh
        self.bpd = batch_per_device
        self.n_dev = mesh.shape["ue"]
        self.batch = self.bpd * self.n_dev

        def sharded(keys, n0):
            ok = step_fn(keys, n0)
            if isinstance(ok, tuple):
                ok = ok[0]
            err = jnp.sum(~ok).astype(jnp.int32)
            # global reduction over the mesh — rides NVLink, not host code
            return jax.lax.psum(err, "ue")

        self._step = jax.jit(shard_map(
            sharded, mesh=mesh,
            in_specs=(P("ue"), P()),
            out_specs=P(), check_vma=False))

    def run_snr(self, snr_db: float, n_frames: int, seed: int = 0):
        n0 = jnp.float32(10.0 ** (-snr_db / 10.0))
        errs = trials = 0
        spec = NamedSharding(self.mesh, P("ue"))
        for i in range(-(-n_frames // self.batch)):
            keys = jax.device_put(host_keys(seed, self.batch, stream=i), spec)
            errs += int(self._step(keys, n0))
            trials += self.batch
        return errs, trials
