import numpy as np
import jax.numpy as jnp
import pytest

from openair4g_tpu.ops.equalize_llr import mrc_llr
from openair4g_tpu.ops.llr import demap_llr
from openair4g_tpu.phy.equalize import mrc_equalize


@pytest.mark.parametrize("Qm", [2, 4, 6])
@pytest.mark.parametrize("A", [1, 2])
def test_fused_kernel_matches_two_stage_oracle(Qm, A):
    rng = np.random.default_rng(Qm * 10 + A)
    B, R = 3, 700                       # non-multiple of the lane tile
    y = (rng.normal(size=(B, R, A)) +
         1j * rng.normal(size=(B, R, A))).astype(np.complex64)
    H = (rng.normal(size=(B, R, A)) +
         1j * rng.normal(size=(B, R, A))).astype(np.complex64)
    n0 = 0.37

    x_hat, n0_eff = mrc_equalize(jnp.asarray(y), jnp.asarray(H), n0)
    want = np.asarray(demap_llr(x_hat, n0_eff, Qm))
    got = np.asarray(mrc_llr(jnp.asarray(y), jnp.asarray(H), n0, Qm))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_dispatch_cpu_uses_oracle():
    """Unit channel, QPSK: the closed form reduces to llr = 4*l*y/n0 on
    both axes."""
    rng = np.random.default_rng(0)
    y = (rng.normal(size=(2, 50, 1)) + 1j * rng.normal(size=(2, 50, 1))
         ).astype(np.complex64)
    H = np.ones((2, 50, 1), np.complex64)
    out = np.asarray(mrc_llr(jnp.asarray(y), jnp.asarray(H), 1.0, 2))
    assert out.shape == (2, 50, 2)
    # unit channel, QPSK: llr = 4*l*y_axis/n0
    lv = 1 / np.sqrt(2)
    np.testing.assert_allclose(out[..., 0], 4 * lv * y[..., 0].real,
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out[..., 1], 4 * lv * y[..., 0].imag,
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("Qm", [2, 4, 6])
def test_fused_kernel_per_re_noise(Qm):
    """Vector n0 (estimation-error weighting / SM effective noise) through
    the closed form matches the two-stage oracle."""
    rng = np.random.default_rng(Qm)
    B, R, A = 2, 300, 2
    y = (rng.normal(size=(B, R, A)) +
         1j * rng.normal(size=(B, R, A))).astype(np.complex64)
    H = (rng.normal(size=(B, R, A)) +
         1j * rng.normal(size=(B, R, A))).astype(np.complex64)
    n0 = rng.uniform(0.1, 2.0, size=(B, R)).astype(np.float32)

    x_hat, n0_eff = mrc_equalize(jnp.asarray(y), jnp.asarray(H),
                                 jnp.asarray(n0))
    want = np.asarray(demap_llr(x_hat, n0_eff, Qm))
    got = np.asarray(mrc_llr(jnp.asarray(y), jnp.asarray(H),
                             jnp.asarray(n0), Qm))
    np.testing.assert_allclose(got, want, rtol=3e-4, atol=3e-4)
