"""DL precoding: codebooks, large-delay CDD, layer mapping (36.211 §6.3.4).

Reference parity: openair1/PHY/LTE_TRANSPORT/dlsch_modulation.c (TM3-6
precoding paths in allocate_REs_in_RB, per-RB PMI via get_pmi :1136) and
dlsch_demodulation.c:1273-1443 (PMI precoder recombination at the UE —
the receiver forms the *effective* channel H·W before detection, which is
exactly how it is computed here).

Precoding is a tiny einsum over the layer axis with a per-RE
precoder tensor [N, P, L]; TM3's large-delay CDD alternates a static pair
of matrices (period = n_layers), so the whole subframe's precoders are one
gathered constant — no per-RE control flow.
"""
from __future__ import annotations

import functools

import numpy as np
import jax.numpy as jnp

_S2 = 1.0 / np.sqrt(2.0)


@functools.lru_cache(maxsize=None)
def codebook_2tx(rank: int) -> np.ndarray:
    """2-antenna-port codebook, 36.211 Table 6.3.4.2.3-1.

    rank 1 -> [4, 2, 1]; rank 2 -> [3, 2, 2] (PMI 0 is the TM3 identity)."""
    if rank == 1:
        cols = np.array([[1, 1], [1, -1], [1, 1j], [1, -1j]],
                        np.complex64) * _S2
        return cols[:, :, None]
    w0 = np.eye(2, dtype=np.complex64) * _S2
    w1 = np.array([[1, 1], [1, -1]], np.complex64) / 2.0
    w2 = np.array([[1, 1j], [1, -1j]], np.complex64) / 2.0
    return np.stack([w0, w1, w2])


@functools.lru_cache(maxsize=None)
def cdd_precoders_2tx(n_re: int) -> np.ndarray:
    """Large-delay CDD effective precoders for 2 ports / 2 layers:
    W_eff(i) = W · D(i) · U with W = I/sqrt2, U = [[1,1],[1,-1]]/sqrt2,
    D(i) = diag(1, (-1)^i)  ->  alternates two constant matrices.
    Returns [n_re, 2, 2]."""
    U = np.array([[1, 1], [1, -1]], np.complex64) * _S2
    out = np.zeros((2, 2, 2), np.complex64)
    for i in range(2):
        D = np.diag([1.0, (-1.0) ** i]).astype(np.complex64)
        out[i] = _S2 * np.eye(2) @ D @ U
    idx = np.arange(n_re) % 2
    return out[idx]


def layer_map(cw_syms: list) -> jnp.ndarray:
    """Codeword->layer mapping (36.211 §6.3.3.2, 2 codewords -> 2 layers):
    cw_syms = [x0 [B, N], x1 [B, N]] -> s [B, N, L]."""
    return jnp.stack(cw_syms, axis=-1)


def precode(s, W):
    """s [B, N, L] layer symbols, W [N, P, L] or [P, L] -> tx [B, N, P]."""
    W = jnp.asarray(W)
    if W.ndim == 2:
        return jnp.einsum("bnl,pl->bnp", s, W)
    return jnp.einsum("bnl,npl->bnp", s, W)


def effective_channel(H, W):
    """H [B, R, N, P] per-RE channel, W [N, P, L] or [P, L] ->
    He [B, N, R, L] (detection layout)."""
    W = jnp.asarray(W)
    if W.ndim == 2:
        He = jnp.einsum("brnp,pl->bnrl", H, W)
    else:
        He = jnp.einsum("brnp,npl->bnrl", H, W)
    return He
