"""Real 2-process jax.distributed run over localhost (CPU backend):
the network path the multi-host design rides — gRPC coordination service,
jax.make_array_from_process_local_data per-process key slices, psum'd
accumulators — executed for real, and asserted bit-identical to the
single-process run with the same global batch (SURVEY.md §4's multi-host
requirement).
"""
import json
import os
import socket
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_procs(nprocs: int, devices_per_proc: int, out: str,
               timeout: int = 420):
    port = _free_port()
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)           # set per-proc via --host-devices
    args = [sys.executable, "-m", "openair4g_tpu.parallel.distributed",
            "--platform", "cpu", "--host-devices", str(devices_per_proc),
            "--mcs", "4", "--n-rb", "6", "--snrs=-1:0:1.0",
            "--frames", "128", "--batch-per-device", "8"]
    procs = []
    for pid in range(nprocs):
        cmd = list(args)
        if nprocs > 1:
            cmd += ["--coordinator", f"127.0.0.1:{port}",
                    "--nprocs", str(nprocs), "--proc-id", str(pid)]
        if pid == 0:
            cmd += ["--out", out]
        procs.append(subprocess.Popen(
            cmd, cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    outs = []
    for p in procs:
        stdout, _ = p.communicate(timeout=timeout)
        outs.append(stdout.decode())
        assert p.returncode == 0, stdout.decode()[-2000:]
    with open(out) as f:
        return json.load(f), outs


def test_two_process_matches_single_process(tmp_path):
    rows1, _ = _run_procs(1, 8, str(tmp_path / "single.json"))
    rows2, logs = _run_procs(2, 4, str(tmp_path / "dual.json"))
    # same global batch (8 devices x 8) and same seed-indexed keys =>
    # bit-identical error counts at every SNR point
    assert rows1 == rows2, (rows1, rows2)
    assert any("x 2 hosts" in log for log in logs), logs[0][-500:]
