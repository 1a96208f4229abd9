"""Execution-timeline tracing — the VCD signal dumper's equivalent.

Reference parity: openair2/UTIL/LOG/vcd_signal_dumper.c:274-470 (function
enter/exit events through a lock-free FIFO to a GTKWave VCD file, enabled
with -V). Here the artifact is a jax.profiler trace (Perfetto/TensorBoard
format): per-XLA-op device timeline + host Python annotations. Sims take
a `trace_dir` option and wrap one representative step in `trace()`;
`annotate()` marks pipeline stages so they show as named spans.

The cheap always-on layer is utils/profiler.py (time_meas-style stage
stats printed at sim exit like dlsim.c:3266+); this module is the opt-in
deep view.
"""
from __future__ import annotations

import contextlib
import os

import jax


@contextlib.contextmanager
def trace(outdir: str):
    """Record a Perfetto trace of everything inside the context. Viewable
    with ui.perfetto.dev or TensorBoard. Degrades to a no-op (with a
    warning) on runtimes without profiler support."""
    started = False
    try:
        os.makedirs(outdir, exist_ok=True)
        jax.profiler.start_trace(outdir)
        started = True
    except Exception as e:                      # pragma: no cover
        print(f"[tracing] profiler unavailable: {e}")
    try:
        yield
    finally:
        if started:
            try:
                jax.profiler.stop_trace()
            except Exception as e:              # pragma: no cover
                print(f"[tracing] stop_trace failed: {e}")


def annotate(name: str):
    """Named span on the trace timeline (TraceAnnotation), usable as a
    context manager — the VCD 'signal' equivalent."""
    return jax.profiler.TraceAnnotation(name)


def trace_artifacts(outdir: str) -> list:
    """Paths of trace files produced under `outdir` (for tests/tooling)."""
    found = []
    for root, _, files in os.walk(outdir):
        for f in files:
            if "trace" in f or f.endswith((".pb", ".json.gz", ".xplane.pb")):
                found.append(os.path.join(root, f))
    return found
