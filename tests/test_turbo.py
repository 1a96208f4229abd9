import numpy as np
import jax.numpy as jnp
import pytest

from openair4g_tpu.ops import turbo
from openair4g_tpu.ops.crc import attach_crc_host


def test_trellis_terminates():
    rng = np.random.default_rng(0)
    for K in (40, 64, 512):
        bits = rng.integers(0, 2, K)
        x, z = turbo._rsc_encode_host(bits)
        assert len(x) == K + 3


def test_qpp_bijection():
    for K in (40, 128, 6144):
        pi = turbo.qpp_interleaver(K)
        assert len(set(pi.tolist())) == K


@pytest.mark.parametrize("K", [40, 104, 512, 6144])
def test_device_encoder_matches_host(K):
    rng = np.random.default_rng(1)
    bits = rng.integers(0, 2, (4, K)).astype(np.int32)
    pi = turbo.qpp_interleaver(K)
    d_dev = np.asarray(turbo.turbo_encode_device(jnp.asarray(bits), pi))
    for b in range(4):
        d_host = turbo.turbo_encode_host(bits[b])
        np.testing.assert_array_equal(d_dev[b], d_host)


@pytest.mark.parametrize("K", [40, 136, 512])
def test_decode_noiseless_roundtrip(K):
    """BPSK LLRs with no noise must decode exactly, CRC pass."""
    rng = np.random.default_rng(2)
    B = 8
    payload = rng.integers(0, 2, (B, K - 24))
    bits = np.stack([attach_crc_host(p, "crc24a") for p in payload])
    pi = turbo.qpp_interleaver(K)
    d = np.asarray(turbo.turbo_encode_device(jnp.asarray(bits.astype(np.int32)), pi))
    llr = (1.0 - 2.0 * d) * 4.0  # bit0 -> +4, bit1 -> -4
    cfg = turbo.TurboDecoderConfig(K=K, n_iter=4)
    out_bits, ok = turbo.turbo_decode(jnp.asarray(llr, jnp.float32), cfg)
    np.testing.assert_array_equal(np.asarray(out_bits), bits)
    assert bool(np.all(np.asarray(ok)))


def test_decode_with_noise_moderate_snr():
    """At Es/N0 ~ 1 dB, rate-1/3 K=512 should decode essentially always."""
    rng = np.random.default_rng(3)
    K, B = 512, 16
    payload = rng.integers(0, 2, (B, K - 24))
    bits = np.stack([attach_crc_host(p, "crc24a") for p in payload])
    pi = turbo.qpp_interleaver(K)
    d = np.asarray(turbo.turbo_encode_device(jnp.asarray(bits.astype(np.int32)), pi))
    snr_db = 1.0
    sigma = np.sqrt(1.0 / (2 * 10 ** (snr_db / 10)))
    y = (1.0 - 2.0 * d) + sigma * rng.standard_normal(d.shape)
    llr = 2.0 * y / sigma**2
    cfg = turbo.TurboDecoderConfig(K=K, n_iter=8)
    out_bits, ok = turbo.turbo_decode(jnp.asarray(llr, jnp.float32), cfg)
    assert np.asarray(ok).mean() >= 0.9
    good = np.asarray(ok)
    np.testing.assert_array_equal(np.asarray(out_bits)[good], bits[good])


@pytest.mark.parametrize("B,W,U,lanes,N", [
    (2, 48, 24, 32, 96),       # 4 lanes padded to one 32-lane block
    (3, 32, 16, 64, 160),      # 15 lanes, U = W/2
    (5, 16, 8, 32, 48),        # 15 lanes, three windows per block
    (7, 24, 24, 32, 72),       # 21 lanes, U = W
])
def test_pallas_half_iteration_matches_xla(B, W, U, lanes, N):
    """The Pallas half-iteration (interpret mode) equals the XLA scan on
    every node but the last of each window. There the kernel takes beta
    from its own warm-up over the next window's head, where the scan
    uses the next window's fully recursed beta: both are max-log
    estimates of the same metric."""
    from openair4g_tpu.ops.turbo_pallas import half_iteration, prep_parity
    rng = np.random.default_rng(B * W + U)
    lin = jnp.asarray(3 * rng.standard_normal((B, N)), jnp.float32)
    lp = jnp.asarray(3 * rng.standard_normal((B, N)), jnp.float32)
    ref = np.asarray(turbo._half_iteration(lin, lp, W, U))
    out = np.asarray(half_iteration(lin, prep_parity(lp, W, U, lanes),
                                    W, U, lanes, interpret=True))
    assert out.shape == ref.shape == (B, N)
    interior = np.ones(N, bool)
    interior[W - 1::W] = False
    np.testing.assert_allclose(out[:, interior], ref[:, interior],
                               rtol=1e-6, atol=1e-5)
    # the last window ends in the exact trellis terminal state in both
    np.testing.assert_allclose(out[:, -1], ref[:, -1], rtol=1e-6, atol=1e-5)


def test_pallas_closed_form_trellis_matches_tables():
    """The kernel's iota-derived trellis wiring (turbo_pallas docstring
    formulas) must equal the table build in ops/turbo._trellis."""
    from openair4g_tpu.ops import turbo as t
    s = np.arange(8)
    for u in (0, 1):
        a = (u ^ (s >> 1) ^ s) & 1
        np.testing.assert_array_equal((a << 2) | (s >> 1),
                                      t.NEXT_STATE[:, u])
        np.testing.assert_array_equal((u ^ (s >> 2) ^ (s >> 1)) & 1,
                                      t.PARITY[:, u])
    for sp in range(8):
        mine = []
        for j in (0, 1):
            u0 = (((sp >> 2) ^ sp) & 1) ^ j
            z0 = (((sp >> 2) ^ (sp >> 1)) & 1) ^ j
            mine.append((2 * (sp & 3) + j, u0, z0))
        ref = [(int(t.PRED_S[sp, j]), int(t.PRED_U[sp, j]),
                int(t.PRED_Z[sp, j])) for j in (0, 1)]
        assert sorted(mine) == sorted(ref), sp


def test_dynamic_stop_output_identical():
    """The while-loop early exit (dynamic_stop) must be output-identical
    to the fixed 8-iteration scan on a mixed pass/fail batch."""
    import numpy as np
    import jax.numpy as jnp
    from openair4g_tpu.ops.turbo import (TurboDecoderConfig, turbo_decode,
                                         turbo_encode_host)
    from openair4g_tpu.ops.crc import attach_crc_host
    K = 512
    rng = np.random.default_rng(3)
    tbs = np.stack([attach_crc_host(rng.integers(0, 2, K - 24), "crc24a")
                    for _ in range(16)])
    d = np.stack([turbo_encode_host(t) for t in tbs])
    llr = jnp.asarray((1 - 2 * d) * 2.0 + rng.normal(size=d.shape) * 2.3,
                      jnp.float32)
    bd, okd = turbo_decode(llr, TurboDecoderConfig(K=K, dynamic_stop=True))
    bs, oks = turbo_decode(llr, TurboDecoderConfig(K=K, dynamic_stop=False))
    assert 0 < int(okd.sum()) < 16, "want a mixed batch"
    assert bool(jnp.array_equal(okd, oks))
    assert bool(jnp.array_equal(bd, bs))
