"""Context-parallel (time-sharded) PSS matched filtering with halo exchange.

Reference parity: the reference's "long sequence" is the IQ sample stream,
processed block-wise with explicit wraparound copies at block edges
(MODULATION/slot_fep.c:125-128) — SURVEY.md §5 maps this to sharding the
sample-time axis with a cyclic-prefix/overlap-save halo exchanged between
neighbor devices.

Here the 5 ms cell-search capture is sharded into contiguous time blocks
over the mesh's "t" axis; each device FFT-correlates its block against the
3 PSS replicas, needing only a (n_fft-1)-sample halo from its right
neighbor — one `ppermute`. The global peak is found with an `all_gather`
of per-shard (max, argmax). This is the ring/context-parallel decomposition
of N11 (SURVEY.md §2.13) for captures too long for one device's HBM.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..phy.sync import pss_time_replica


def sharded_pss_correlate(mesh: Mesh, n_fft: int, block_len: int):
    """Build a jitted sharded correlator.

    Returns fn(r [B, n_t*block_len] sharded on "t") ->
    (pos [B], nid2 [B], peak [B]) replicated — the argmax over the whole
    capture of |corr(t, replica)|^2 for the 3 PSS replicas.
    """
    n_t = mesh.shape["t"]
    reps = np.stack([pss_time_replica(i, n_fft) for i in range(3)])
    fft_len = 1 << (block_len + n_fft - 1).bit_length()
    rep_pad = np.zeros((3, fft_len), np.complex64)
    rep_pad[:, :n_fft] = reps
    rep_f_conj = np.conj(np.fft.fft(rep_pad, axis=1)).astype(np.complex64)

    def kernel(blk):
        # blk [B, block_len] — this device's time block
        B = blk.shape[0]
        idx = jax.lax.axis_index("t")
        # halo: first n_fft samples of the RIGHT neighbor's block
        perm = [(i, (i - 1) % n_t) for i in range(n_t)]
        halo = jax.lax.ppermute(blk[:, :n_fft], "t", perm)
        ext = jnp.concatenate([blk, halo], axis=-1)      # [B, bl + n_fft]
        rf = jnp.fft.fft(ext, n=fft_len, axis=-1)
        corr = jnp.fft.ifft(rf[:, None, :] * jnp.asarray(rep_f_conj),
                            axis=-1)[..., :block_len]    # [B, 3, bl]
        e = jnp.abs(corr) ** 2
        # the final block's tail has wrapped (invalid) halo: mask it there
        t = jnp.arange(block_len)
        last = idx == n_t - 1
        valid = jnp.where(last, t < block_len - n_fft, True)
        e = jnp.where(valid[None, None, :], e, 0.0)
        flat = e.reshape(B, -1)
        loc_max = jnp.max(flat, axis=-1)                 # [B]
        loc_arg = jnp.argmax(flat, axis=-1)
        # global reduction: gather per-shard winners, pick the best
        all_max = jax.lax.all_gather(loc_max, "t")       # [n_t, B]
        all_arg = jax.lax.all_gather(loc_arg, "t")
        win = jnp.argmax(all_max, axis=0)                # [B]
        arg = jnp.take_along_axis(all_arg, win[None, :], axis=0)[0]
        nid2 = arg // block_len
        pos = win * block_len + arg % block_len
        peak = jnp.max(all_max, axis=0)
        return pos, nid2, peak

    return jax.jit(shard_map(
        kernel, mesh=mesh, in_specs=P(None, "t"),
        out_specs=(P(), P(), P()), check_vma=False))
