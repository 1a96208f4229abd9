"""Kernel-against-reference checks at the 20 MHz flagship's widths.

Used by `chip_smoke.py` and by the tests marked `gpu`: each check runs
the decoder's kernel as compiled for the default backend next to its
plain reference and returns the largest difference with the tolerance it
is held to.

Flagship widths: 20 MHz, MCS 26 gives 11 code blocks of K = 5632 per
subframe, so a batch of 128 subframes decodes 1408 blocks at once.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

FLAGSHIP_K = 5632
FLAGSHIP_BLOCKS = 11 * 128
FLAGSHIP_DATA_RE = 15000          # 100 PRB, 1 PDCCH symbol


def _flagship_llrs(W: int, seed: int = 0):
    from ..ops.turbo import _padded_len
    N = _padded_len(FLAGSHIP_K + 3, W)
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    shape = (FLAGSHIP_BLOCKS, N)
    return (3.0 * jax.random.normal(k1, shape, jnp.float32),
            3.0 * jax.random.normal(k2, shape, jnp.float32))


def turbo_kernel_check() -> dict:
    """The Pallas half-iteration against the XLA scan, on every node but
    the last of each window (there the two take beta from different,
    equally valid warm-ups; tests/test_turbo.py)."""
    from ..ops import turbo
    from ..ops.decoder_settings import decoder_settings
    from ..ops import turbo_pallas

    s = decoder_settings()
    W, U = s.window, s.warmup
    lin, lp = _flagship_llrs(W)
    ref = jax.jit(lambda a, b: turbo._half_iteration(a, b, W, U, s.unroll))
    ker = jax.jit(lambda a, b: turbo_pallas.half_iteration(
        a, turbo_pallas.prep_parity(b, W, U, s.lanes), W, U, s.lanes))
    want = np.asarray(ref(lin, lp))
    got = np.asarray(ker(lin, lp))
    interior = np.ones(want.shape[1], bool)
    interior[W - 1::W] = False
    err = float(np.max(np.abs(got[:, interior] - want[:, interior])))
    return dict(name=f"turbo half-iteration ({s.half_iter}, W={W}, U={U}, "
                     f"lanes={s.lanes}) vs XLA scan",
                max_abs_err=err, tol=1e-3, shape=tuple(want.shape),
                precision="float32 elementwise, no matmul")


def mrc_llr_check() -> dict:
    """ops/equalize_llr.mrc_llr (one fused jnp form) against
    phy/equalize.mrc_equalize + ops/llr.demap_llr, 64QAM, per-RE noise."""
    from ..ops.equalize_llr import mrc_llr
    from ..ops.llr import demap_llr
    from ..phy.equalize import mrc_equalize

    B, R, Qm = 128, FLAGSHIP_DATA_RE, 6
    ks = jax.random.split(jax.random.PRNGKey(1), 5)
    y = (jax.random.normal(ks[0], (B, R, 1))
         + 1j * jax.random.normal(ks[1], (B, R, 1))).astype(jnp.complex64)
    H = (jax.random.normal(ks[2], (B, R, 1))
         + 1j * jax.random.normal(ks[3], (B, R, 1))).astype(jnp.complex64)
    n0 = jax.random.uniform(ks[4], (B, R), jnp.float32, 0.5, 2.0)
    got = np.asarray(jax.jit(mrc_llr, static_argnums=3)(y, H, n0, Qm))
    want = np.asarray(jax.jit(
        lambda y, H, n0: demap_llr(*mrc_equalize(y, H, n0), Qm))(y, H, n0))
    return dict(name="MRC+LLR closed form vs two-stage",
                max_abs_err=float(np.max(np.abs(got - want))), tol=2e-3,
                shape=tuple(got.shape),
                precision="float32/complex64 elementwise, no matmul")
