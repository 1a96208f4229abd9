"""Kernels as compiled for the GPU, at the flagship's widths.

These need the card: they skip elsewhere, and `python chip_smoke.py`
runs them there (its kernels phase)."""
import pytest

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    import jax
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU; run `python chip_smoke.py` there")


def test_turbo_kernel_compiles_at_flagship_widths(gpu):
    import jax
    from openair4g_tpu.ops import turbo_pallas
    from openair4g_tpu.ops.decoder_settings import decoder_settings
    from openair4g_tpu.utils.kernel_checks import _flagship_llrs

    s = decoder_settings()
    lin, lp = _flagship_llrs(s.window)
    fn = jax.jit(lambda a, b: turbo_pallas.half_iteration(
        a, turbo_pallas.prep_parity(b, s.window, s.warmup, s.lanes),
        s.window, s.warmup, s.lanes))
    compiled = fn.lower(lin, lp).compile()
    assert compiled(lin, lp).shape == lin.shape


def test_turbo_kernel_matches_xla_on_card(gpu):
    from openair4g_tpu.utils.kernel_checks import turbo_kernel_check
    r = turbo_kernel_check()
    assert r["max_abs_err"] <= r["tol"], r


def test_mrc_llr_matches_two_stage_on_card(gpu):
    from openair4g_tpu.utils.kernel_checks import mrc_llr_check
    r = mrc_llr_check()
    assert r["max_abs_err"] <= r["tol"], r
