"""Pallas kernel (Triton route) for the windowed max-log-MAP half-iteration.

Same BCJR math as ops/turbo._half_iteration, which stays the plain XLA
path and the reference for this kernel. The XLA path is a `lax.scan`
that writes [W+U, 8, B, n_w] alpha and beta stacks to device memory and
reads them back for the LLR, with a few small launches per scan step.
Here one launch covers the whole half-iteration:

  * one lane = one (code block, window) pair; a block of `lanes` lanes is
    one Triton program, and each thread owns its lanes' 8 state metrics
    in registers for the whole recursion;
  * the backward sweep writes the window's beta metrics once ([W+1, 8]
    per lane, a second output that the caller discards); the forward
    sweep reads them back in the same program and emits the LLR, so the
    alpha metrics never leave registers;
  * the warm-up rows come from the neighbouring window's lanes (a one-lane
    roll of the t-major frames), so nothing carries between programs.

Inputs are t-major ([W, L] and [U, L], L = blocks x windows, padded to a
multiple of `lanes`), which makes every row load and store coalesced.
"""
from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from . import turbo as _t

_NEXT = _t.NEXT_STATE.tolist()
_PAR = _t.PARITY.tolist()
_PRED_S = _t.PRED_S.tolist()
_PRED_U = _t.PRED_U.tolist()
_PRED_Z = _t.PRED_Z.tolist()


def _sign(bit: int) -> float:
    return 1.0 - 2.0 * bit


def _norm(m):
    top = m[0]
    for s in range(1, 8):
        top = jnp.maximum(top, m[s])
    return tuple(x - top for x in m)


def _alpha_step(alpha, gu, gp):
    new = []
    for s in range(8):
        c = [alpha[_PRED_S[s][j]] + _sign(_PRED_U[s][j]) * gu
             + _sign(_PRED_Z[s][j]) * gp for j in (0, 1)]
        new.append(jnp.maximum(c[0], c[1]))
    return _norm(new)


def _beta_step(beta, gu, gp):
    new = []
    for s in range(8):
        c = [beta[_NEXT[s][u]] + _sign(u) * gu + _sign(_PAR[s][u]) * gp
             for u in (0, 1)]
        new.append(jnp.maximum(c[0], c[1]))
    return _norm(new)


def _make_kernel(W: int, U: int, lanes: int, barrier: bool):
    def kernel(gum, guw, gut, gpm, gpw, gpt, flags, out, beta_st):
        win0 = flags[0, :] > 0.5
        winlast = flags[1, :] > 0.5
        zeros = tuple(jnp.zeros((lanes,), jnp.float32) for _ in range(8))

        def exact0(mask, m):
            return tuple(jnp.where(mask, 0.0 if s == 0 else _t.NEG, m[s])
                         for s in range(8))

        # backward: warm-up over the next window's head, then the window
        def bwarm(i, beta):
            t = U - 1 - i
            return _beta_step(beta, gut[t, :], gpt[t, :])

        beta = jax.lax.fori_loop(0, U, bwarm, zeros)
        term = exact0(winlast, beta)       # the trellis end is state 0
        for s in range(8):
            beta_st[W, s, :] = term[s]

        def bmain(i, beta):
            t = W - 1 - i
            beta = _beta_step(beta, gum[t, :], gpm[t, :])
            for s in range(8):
                beta_st[t, s, :] = beta[s]
            return beta

        jax.lax.fori_loop(0, W, bmain, beta)
        if barrier:
            pltriton.debug_barrier()

        # forward: warm-up over the previous window's tail, then the
        # window with the LLR fused in
        def fwarm(t, alpha):
            return _alpha_step(alpha, guw[t, :], gpw[t, :])

        alpha = exact0(win0, jax.lax.fori_loop(0, U, fwarm, zeros))

        def work(t, alpha):
            gu = gum[t, :]
            gp = gpm[t, :]
            bn = [beta_st[t + 1, s, :] for s in range(8)]
            m = []
            for u in (0, 1):
                best = None
                for s in range(8):
                    c = alpha[s] + _sign(_PAR[s][u]) * gp + bn[_NEXT[s][u]]
                    best = c if best is None else jnp.maximum(best, c)
                m.append(best)
            out[t, :] = (m[0] + gu) - (m[1] - gu)
            return _alpha_step(alpha, gu, gp)

        jax.lax.fori_loop(0, W, work, alpha)

    return kernel


@functools.lru_cache(maxsize=None)
def _build_call(W: int, U: int, n_lanes: int, lanes: int,
                interpret: bool = False):
    spec_w = pl.BlockSpec((W, lanes), lambda i: (0, i))
    spec_u = pl.BlockSpec((U, lanes), lambda i: (0, i))
    return pl.pallas_call(
        _make_kernel(W, U, lanes, barrier=not interpret),
        grid=(n_lanes // lanes,),
        in_specs=[spec_w, spec_u, spec_u, spec_w, spec_u, spec_u,
                  pl.BlockSpec((2, lanes), lambda i: (0, i))],
        out_specs=[spec_w,
                   pl.BlockSpec((W + 1, 8, lanes), lambda i: (0, 0, i))],
        out_shape=[jax.ShapeDtypeStruct((W, n_lanes), jnp.float32),
                   jax.ShapeDtypeStruct((W + 1, 8, n_lanes), jnp.float32)],
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=max(1, lanes // 32),
                                                num_stages=1),
        interpret=interpret,
        name="turbo_half_iteration",
    )


def _tmajor_frames(g, W: int, U: int, win0, winlast, tail_fill: float):
    """[B, N] -> (main [W, L0], fwd warm-up [U, L0], bwd warm-up [U, L0]).

    Lane b*n_w + w is window w of block b, so window w's forward warm-up
    (positions w*W - U + t) is the tail of lane - 1 and its backward
    warm-up (positions (w+1)*W + t) is the head of lane + 1."""
    B, N = g.shape
    n_w = N // W
    gm = jnp.moveaxis(g.reshape(B, n_w, W), -1, 0).reshape(W, B * n_w)
    gw = jnp.where(win0, 0.0, jnp.roll(gm[W - U:], 1, axis=1))
    gt = jnp.where(winlast, tail_fill, jnp.roll(gm[:U], -1, axis=1))
    return gm, gw, gt


def _lane_flags(B: int, n_w: int):
    w = np.tile(np.arange(n_w), B)
    return w == 0, w == n_w - 1


def _pad_lanes(x, n_lanes: int, fill: float = 0.0):
    pad = n_lanes - x.shape[-1]
    return jnp.pad(x, ((0, 0), (0, pad)), constant_values=fill) if pad else x


def prep_parity(lp, W: int, U: int, lanes: int):
    """Frame the parity gammas once per code block: they are the same in
    every turbo iteration."""
    B, N = lp.shape
    n_w = N // W
    n_lanes = -(-B * n_w // lanes) * lanes
    win0, winlast = _lane_flags(B, n_w)
    gm, gw, gt = _tmajor_frames(0.5 * lp, W, U, win0, winlast, _t.BIG)
    return (_pad_lanes(gm, n_lanes), _pad_lanes(gw, n_lanes),
            _pad_lanes(gt, n_lanes, _t.BIG))


def half_iteration(lin, prep, W: int, U: int, lanes: int,
                   interpret: bool = False):
    """lin [B, N] systematic+apriori LLRs, `prep` from prep_parity ->
    APP LLR [B, N], as ops/turbo._half_iteration(lin, lp, W, U)."""
    gpm, gpw, gpt = prep
    B, N = lin.shape
    n_w = N // W
    L0 = B * n_w
    n_lanes = gpm.shape[1]
    win0, winlast = _lane_flags(B, n_w)
    gum, guw, gut = _tmajor_frames(0.5 * lin, W, U, win0, winlast, _t.BIG)
    flags = _pad_lanes(jnp.asarray(np.stack([win0, winlast]), jnp.float32),
                       n_lanes)
    out, _ = _build_call(W, U, n_lanes, lanes, interpret)(
        _pad_lanes(gum, n_lanes), _pad_lanes(guw, n_lanes),
        _pad_lanes(gut, n_lanes, _t.BIG), gpm, gpw, gpt, flags)
    out = out[:, :L0].reshape(W, B, n_w)
    return jnp.moveaxis(out, 0, 2).reshape(B, N)
