"""FITC/Nyström inducing-point path for n >> 10^4.

The reference drafted and abandoned a Nyström sparse kernel (dead code at
reference covmat.py:57-93); this is the working equivalent.

Both exact losses share one algebraic core per component (likelihood.py):

    u    = (C + Lam)^{-1} Lam b          Lam diagonal:
    quad = b^T C u                         rep:  Lam = 1/(D r)
    ld   = logdet(C + Lam)                 full: Lam = (1/D) 1

FITC replaces the smooth kernel part with its Nyström approximation
Q = Knm Kmm^{-1} Kmn plus an exact diagonal correction:

    C_hat = Q + diag(c_diag - q_diag),  c_diag = amp (Matern diag)

so C_hat + Lam = W W^T + Lam~ with W = Knm Lmm^{-T} (n, m) and
Lam~ = Lam + c_diag - q_diag.  Woodbury gives everything at O(n m^2)
per component instead of O(n^3):

    M  = I_m + W^T Lam~^{-1} W,   LM = chol(M)
    (C_hat + Lam)^{-1} v = Lam~^{-1} v - Lam~^{-1} W M^{-1} W^T Lam~^{-1} v
    logdet(C_hat + Lam) = sum log Lam~ + logdet(M)

All of it batched over the q component axis (the (q, n, m) W stack is the
big resident object — n=50k, m=512, q=5 is ~1 GB in f64).
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple, Union

import numpy as np

import jax
import jax.numpy as jnp

from ..ops import linalg
from ..ops.gram import gram_stack
from ..ops.matern import matern32_diag
from . import params as P
from .likelihood import FullData, RepData

# jitter on Kmm's diagonal (relative to amplitude): the Nystrom factor is
# rank-deficient by construction when inducing points nearly coincide
KMM_JITTER = 1e-8


def select_inducing(x, m: int):
    """Greedy farthest-point (max-min) selection of m rows of x (n, d).

    Deterministic, O(n m), gives space-filling inducing locations without
    external clustering deps.  Returns the (m, d) subset.
    """
    x = np.asarray(x, dtype=np.float64)
    n = x.shape[0]
    if m >= n:
        return x.copy()
    idx = [int(np.argmin(np.linalg.norm(x - x.mean(0), axis=1)))]
    d2 = np.sum((x - x[idx[0]]) ** 2, axis=1)
    for _ in range(m - 1):
        nxt = int(np.argmax(d2))
        idx.append(nxt)
        d2 = np.minimum(d2, np.sum((x - x[nxt]) ** 2, axis=1))
    return x[np.asarray(idx)]


class FitcCore(NamedTuple):
    """Per-component Woodbury state shared by loss and predict."""
    Lmm: jnp.ndarray      # (q, m, m) chol of Kmm + jitter
    W: jnp.ndarray        # (q, n, m) Knm Lmm^{-T}
    lam_t: jnp.ndarray    # (q, n) Lam~ = Lam + c_diag - q_diag
    LM: jnp.ndarray       # (q, m, m) chol(I + W^T Lam~^{-1} W)


def _fitc_core(xs, z, lLmb, lLmb0, lnug, lam, *, compute_dtype, kernel):
    """Build the Woodbury state.  lam: (q, n) exact diagonal.

    Precision split: the O(n m^2) work (Knm build, the W panel solve, the
    M assembly GEMM) runs in the compute dtype, but the small (m, m)
    factorizations are always f64 — an f32 Cholesky of a near-rank-
    deficient Kmm produces NaNs that no jitter reliably prevents, and at
    m<=1024 the f64 cost is negligible next to the GEMMs.
    """
    Kmm64 = gram_stack(z, z, lLmb, lLmb0, lnug, same=False,
                       compute_dtype=None, kind=kernel)        # (q, m, m) f64
    Kmm64 = Kmm64.astype(jnp.float64)
    amp64 = lLmb0.astype(jnp.float64)
    Lmm64 = linalg.cholesky(
        linalg.add_diag(Kmm64, KMM_JITTER * amp64[:, None]))
    Knm = gram_stack(xs, z, lLmb, lLmb0, lnug, same=False,
                     compute_dtype=compute_dtype, kind=kernel)  # (q, n, m)
    dt = Knm.dtype
    Lmm = Lmm64.astype(dt)
    # W = Knm Lmm^{-T}: solve Lmm W^T = Knm^T
    W = jnp.swapaxes(
        linalg.solve_tri_lower(Lmm, jnp.swapaxes(Knm, -1, -2)), -1, -2)
    q_diag = jnp.sum(jnp.square(W), axis=-1)                   # (q, n)
    c_diag = amp64.astype(dt)[:, None] * jnp.ones_like(q_diag)  # Matern diag
    lam_t = jnp.maximum(
        lam.astype(dt) + jnp.maximum(c_diag - q_diag, 0.0),
        jnp.asarray(1e-10, dtype=dt))
    WtLi = jnp.swapaxes(W, -1, -2) / lam_t[:, None, :]         # (q, m, n)
    M64 = linalg.add_diag((WtLi @ W).astype(jnp.float64), 1.0)
    LM = linalg.cholesky(M64)                                  # (q, m, m) f64
    return FitcCore(Lmm=Lmm, W=W, lam_t=lam_t, LM=LM)


def _fitc_solve(core: FitcCore, v):
    """(C_hat + Lam)^{-1} v for v (q, n) via Woodbury.  The (m, m) solve
    runs in f64 (LM is an f64 factor); the n-sized ops keep v's dtype."""
    vi = v / core.lam_t
    t = jnp.einsum('qnm,qn->qm', core.W, vi)
    s = linalg.cho_solve_vec(core.LM, t.astype(core.LM.dtype)).astype(v.dtype)
    return vi - jnp.einsum('qnm,qm->qn', core.W, s) / core.lam_t


def _fitc_logdet(core: FitcCore):
    return (jnp.sum(jnp.log(core.lam_t.astype(core.LM.dtype)), axis=-1)
            + linalg.chol_logdet(core.LM))                     # (q,) f64


def _fitc_terms(core: FitcCore, lam, b):
    """(-0.5 quad, 0.5 ld) building blocks: u, quad, ld per component.

    The n-length reductions accumulate in f64 regardless of the compute
    dtype: at n=50k an f32 sum of O(1) terms resolves the loss only to
    ~1e0 absolute, which blinds any line search (observed as L-BFGS
    divergence); the cast costs one n-vector."""
    b = b.astype(core.W.dtype)
    u = _fitc_solve(core, lam.astype(core.W.dtype) * b)
    # C_hat u = W W^T u + (lam_t - lam) u   (diag corr = lam_t - lam)
    Cu = (jnp.einsum('qnm,qm->qn', core.W,
                     jnp.einsum('qnm,qn->qm', core.W, u))
          + (core.lam_t - lam.astype(core.W.dtype)) * u)
    quad = jnp.sum((b * Cu).astype(jnp.float64), axis=-1)
    return u, quad, _fitc_logdet(core)


class FitcStream(NamedTuple):
    """Accumulated Woodbury state from one streaming pass over n-blocks.

    Everything n-sized has been reduced away: only (q, m, m)/(q, m)/(q,)
    accumulators remain, so the resident memory is O(q m^2) + one block's
    (q, n_chunk, m) working set regardless of n.
    """
    Lmm: jnp.ndarray      # (q, m, m) compute-dtype chol of Kmm + jitter
    LM: jnp.ndarray       # (q, m, m) f64 chol(I + G)
    G: jnp.ndarray        # (q, m, m) f64  W^T Lam~^{-1} W
    t: jnp.ndarray        # (q, m)  f64  W^T (Lam b / Lam~)
    s: jnp.ndarray        # (q, m)  f64  M^{-1} t
    quad: jnp.ndarray     # (q,)    f64  b^T C_hat u
    ld: jnp.ndarray       # (q,)    f64  logdet(C_hat + Lam)


def _pad_blocks(n, n_chunk):
    """(n_blocks, pad) for splitting an n-axis into n_chunk-sized blocks."""
    n_blocks = -(-n // n_chunk)
    return n_blocks, n_blocks * n_chunk - n


def _fitc_stream(xs, z, lLmb, lLmb0, lnug, lam, b, n_chunk, *,
                 compute_dtype, kernel):
    """Single-pass streaming (n-blocked) Woodbury accumulation.

    The un-chunked core materializes the (q, n, m) W panel — and its
    backward holds ~3 copies live (measured: n=500k, m=512, q=4 f32 OOMs
    a 15.75 GB chip by 311 MB).  This version scans over n-blocks with a
    rematerialized body: each block builds its Knm/W slice, updates the
    O(q m^2) accumulators, and is recomputed (not stored) in the
    backward, so n is bounded by the (q, n) inputs alone.

    Key identity that makes ONE pass sufficient: with
    u = (C_hat + Lam)^{-1} Lam b,

        C_hat u = (C_hat + Lam) u - Lam u = Lam b - Lam u
        quad = b^T C_hat u = b^T Lam b - b^T Lam u
             = sum lam b^2 - sum (lam b)^2 / lam_t + t^T M^{-1} t

    (expand u = Lam~^{-1}(Lam b) - Lam~^{-1} W M^{-1} t) — so the
    quadratic term needs only the same accumulators as logdet and never a
    second sweep to apply W to u.
    """
    Kmm64 = gram_stack(z, z, lLmb, lLmb0, lnug, same=False,
                       compute_dtype=None, kind=kernel).astype(jnp.float64)
    amp64 = lLmb0.astype(jnp.float64)
    Lmm64 = linalg.cholesky(
        linalg.add_diag(Kmm64, KMM_JITTER * amp64[:, None]))

    q, n = lam.shape
    m = z.shape[0]
    n_blocks, pad = _pad_blocks(n, n_chunk)
    # padded rows reuse xs[0] (finite Gram values) and are masked out of
    # every accumulator by w
    xs_p = jnp.concatenate(
        [xs, jnp.broadcast_to(xs[:1], (pad,) + xs.shape[1:])]) \
        if pad else xs
    lam_p = jnp.concatenate(
        [lam, jnp.ones((q, pad), lam.dtype)], axis=1) if pad else lam
    b_p = jnp.concatenate(
        [b, jnp.zeros((q, pad), b.dtype)], axis=1) if pad else b
    w = jnp.concatenate([jnp.ones((n,)), jnp.zeros((pad,))]) \
        if pad else jnp.ones((n,))

    xs_blk = xs_p.reshape((n_blocks, n_chunk) + xs.shape[1:])
    lam_blk = jnp.moveaxis(lam_p.reshape(q, n_blocks, n_chunk), 1, 0)
    b_blk = jnp.moveaxis(b_p.reshape(q, n_blocks, n_chunk), 1, 0)
    w_blk = w.reshape(n_blocks, n_chunk)

    # probe the block dtype once (host-side, zero cost under jit)
    probe = gram_stack(z[:1], z[:1], lLmb, lLmb0, lnug, same=False,
                       compute_dtype=compute_dtype, kind=kernel)
    dt = probe.dtype
    Lmm = Lmm64.astype(dt)
    amp = amp64.astype(dt)
    f64 = jnp.float64

    def body(carry, blk):
        G, t, sumlog, acc_bb, acc_bu = carry
        xs_b, lam_b, b_b, w_b = blk
        Knm = gram_stack(xs_b, z, lLmb, lLmb0, lnug, same=False,
                         compute_dtype=compute_dtype, kind=kernel)
        W = jnp.swapaxes(
            linalg.solve_tri_lower(Lmm, jnp.swapaxes(Knm, -1, -2)), -1, -2)
        q_diag = jnp.sum(jnp.square(W), axis=-1)               # (q, nc)
        c_diag = amp[:, None] * jnp.ones_like(q_diag)
        lam_dt = lam_b.astype(dt)
        lam_t = jnp.maximum(
            lam_dt + jnp.maximum(c_diag - q_diag, 0.0),
            jnp.asarray(1e-10, dtype=dt))
        b_dt = b_b.astype(dt)
        vi = lam_dt * b_dt / lam_t                             # (q, nc)
        wq = w_b.astype(dt)[None, :]
        G = G + jnp.einsum('qnm,qn,qnk->qmk', W, wq / lam_t, W).astype(f64)
        t = t + jnp.einsum('qnm,qn->qm', W, wq * vi).astype(f64)
        sumlog = sumlog + jnp.sum(
            w_b * jnp.log(lam_t.astype(f64)), axis=-1)
        acc_bb = acc_bb + jnp.sum(
            (wq * lam_dt * b_dt * b_dt).astype(f64), axis=-1)
        acc_bu = acc_bu + jnp.sum(
            (wq * lam_dt * b_dt * vi).astype(f64), axis=-1)
        return (G, t, sumlog, acc_bb, acc_bu), None

    init = (jnp.zeros((q, m, m), f64), jnp.zeros((q, m), f64),
            jnp.zeros((q,), f64), jnp.zeros((q,), f64),
            jnp.zeros((q,), f64))
    (G, t, sumlog, acc_bb, acc_bu), _ = jax.lax.scan(
        jax.checkpoint(body), init, (xs_blk, lam_blk, b_blk, w_blk))

    LM = linalg.cholesky(linalg.add_diag(G, 1.0))
    s = linalg.cho_solve_vec(LM, t)
    quad = acc_bb - acc_bu + jnp.sum(t * s, axis=-1)
    ld = sumlog + linalg.chol_logdet(LM)
    return FitcStream(Lmm=Lmm, LM=LM, G=G, t=t, s=s, quad=quad, ld=ld)


@partial(jax.jit, static_argnames=("compute_dtype", "kernel", "n_chunk"))
def neglpost_full_fitc(free: P.FreeParams, data: FullData, z,
                       compute_dtype=None, kernel: str = "matern32",
                       n_chunk: int | None = None):
    """FITC approximation of the full-data loss (likelihood.neglpost_full
    semantics, reference lcgp.py:635-666) at O(q n m^2)."""
    lLmb, lLmb0, lsig_g, lnug = P.constrain(free)
    lsig = P.expand_sigma(lsig_g, data.sigma_map)
    sigma = jnp.exp(lsig)
    n = data.xs.shape[0]

    psi_c = data.phi / jnp.sqrt(sigma)[:, None]
    a = (data.ys.T @ psi_c).T                                  # (q, n)

    D = data.diag_D
    lam = jnp.broadcast_to((1.0 / D)[:, None], a.shape)        # (q, n)
    if n_chunk:
        st = _fitc_stream(data.xs, z, lLmb, lLmb0, lnug, lam, a, n_chunk,
                          compute_dtype=compute_dtype, kernel=kernel)
        quad, ld = st.quad, st.ld
    else:
        core = _fitc_core(data.xs, z, lLmb, lLmb0, lnug, lam,
                          compute_dtype=compute_dtype, kernel=kernel)
        _, quad, ld = _fitc_terms(core, lam, a)
    # logdet(I + D C_hat) = n log D + logdet(C_hat + (1/D) I)
    terms = 0.5 * (n * jnp.log(D.astype(ld.dtype)) + ld) - 0.5 * quad

    nlp = jnp.sum(terms).astype(data.ys.dtype)
    nlp += 0.5 * n * jnp.sum(lsig)
    nlp += 0.5 * jnp.sum(jnp.square(data.ys / jnp.sqrt(sigma)[:, None]))
    return nlp


@partial(jax.jit, static_argnames=("compute_dtype", "kernel", "n_chunk"))
def neglpost_rep_fitc(free: P.FreeParams, data: RepData, z,
                      compute_dtype=None, kernel: str = "matern32",
                      n_chunk: int | None = None):
    """FITC approximation of the replication loss (likelihood.neglpost_rep
    semantics, reference lcgp.py:554-630) at O(q n m^2)."""
    lLmb, lLmb0, lsig_g, lnug = P.constrain(free)
    lsig = P.expand_sigma(lsig_g, data.sigma_map)
    sigma_raw = jnp.exp(lsig)
    n = data.xs.shape[0]
    p = data.ybar.shape[0]
    r = data.r

    sigma_var_used = sigma_raw / jnp.square(data.scale)
    sigma_inv_sqrt = data.scale / jnp.sqrt(sigma_raw)

    nlp = 0.5 * jnp.sum(r * jnp.sum(
        jnp.square(data.ybar * sigma_inv_sqrt[:, None]), axis=0))
    nlp += 0.5 * n * jnp.sum(jnp.log(sigma_var_used))
    nlp += -0.5 * p * jnp.sum(jnp.log(r))

    v = data.phi * sigma_inv_sqrt[:, None]
    b = r[None, :] * (data.ybar.T @ v).T                       # (q, n)

    D = data.diag_D
    lam = 1.0 / (D[:, None] * r[None, :])                      # (q, n)
    if n_chunk:
        st = _fitc_stream(data.xs, z, lLmb, lLmb0, lnug, lam, b, n_chunk,
                          compute_dtype=compute_dtype, kernel=kernel)
        quad, ld = st.quad, st.ld
    else:
        core = _fitc_core(data.xs, z, lLmb, lLmb0, lnug, lam,
                          compute_dtype=compute_dtype, kernel=kernel)
        _, quad, ld = _fitc_terms(core, lam, b)
    # logdet A = sum_i log(D r_i) + logdet(C_hat + Lam)
    terms = 0.5 * (jnp.sum(jnp.log(D[:, None] * r[None, :]), axis=-1)
                   .astype(ld.dtype) + ld) - 0.5 * quad
    nlp += jnp.sum(terms).astype(nlp.dtype)
    return nlp / n


class FitcAux(NamedTuple):
    """Predictive state: dual weights in inducing space + variance kernel."""
    Lmm: jnp.ndarray      # (q, m, m)
    alpha: jnp.ndarray    # (q, m)  W^T u  (mean: ghat = W0 alpha)
    inner: jnp.ndarray    # (q, m, m) G M^{-1} (variance reduction kernel)
    u: jnp.ndarray        # (q, n) dual weights (diagnostic)


@partial(jax.jit, static_argnames=("mode", "compute_dtype", "kernel",
                                   "n_chunk"))
def compute_aux_fitc(free: P.FreeParams, data, z, mode: str,
                     compute_dtype=None, kernel: str = "matern32",
                     n_chunk: int | None = None) -> FitcAux:
    lLmb, lLmb0, lsig_g, lnug = P.constrain(free)
    lsig = P.expand_sigma(lsig_g, data.sigma_map)
    sigma_raw = jnp.exp(lsig)
    D = data.diag_D

    if mode == 'rep':
        sigma_inv_sqrt = data.scale / jnp.sqrt(sigma_raw)
        v = data.phi * sigma_inv_sqrt[:, None]
        b = data.r[None, :] * (data.ybar.T @ v).T
        lam = 1.0 / (D[:, None] * data.r[None, :])
    else:
        psi_c = data.phi / jnp.sqrt(sigma_raw)[:, None]
        b = (data.ys.T @ psi_c).T
        lam = jnp.broadcast_to((1.0 / D)[:, None], b.shape)

    if n_chunk:
        return _compute_aux_fitc_streamed(
            data.xs, z, lLmb, lLmb0, lnug, lam, b, n_chunk,
            compute_dtype=compute_dtype, kernel=kernel)

    core = _fitc_core(data.xs, z, lLmb, lLmb0, lnug, lam,
                      compute_dtype=compute_dtype, kernel=kernel)
    u = _fitc_solve(core, lam.astype(core.W.dtype) * b.astype(core.W.dtype))
    alpha = jnp.einsum('qnm,qn->qm', core.W, u)
    # G = W^T Lam~^{-1} W = M - I; the variance reduction kernel is
    # G - G M^{-1} G = G M^{-1} (M = I + G commutes with G), symmetric PSD
    Minv = linalg.chol_inverse(core.LM)                        # f64
    G = jnp.einsum('qnm,qn,qnk->qmk', core.W, 1.0 / core.lam_t,
                   core.W).astype(core.LM.dtype)
    inner = G @ Minv
    inner = 0.5 * (inner + jnp.swapaxes(inner, -1, -2))
    return FitcAux(Lmm=core.Lmm, alpha=alpha, inner=inner, u=u)


def _compute_aux_fitc_streamed(xs, z, lLmb, lLmb0, lnug, lam, b, n_chunk, *,
                               compute_dtype, kernel) -> FitcAux:
    """Memory-bounded aux: one accumulation pass (shared with the loss)
    plus a second forward-only sweep for the (q, n) dual weights u.

    alpha = W^T u collapses onto the pass-1 accumulators:
        u = Lam~^{-1}(Lam b) - Lam~^{-1} W s  =>  alpha = t - G s.
    The u sweep recomputes each W block (forward only, nothing stored but
    the (q, n_chunk) outputs), so the resident footprint stays O(q m^2).
    """
    st = _fitc_stream(xs, z, lLmb, lLmb0, lnug, lam, b, n_chunk,
                      compute_dtype=compute_dtype, kernel=kernel)
    dt = st.Lmm.dtype
    alpha = (st.t - jnp.einsum('qmk,qk->qm', st.G, st.s)).astype(dt)
    Minv = linalg.chol_inverse(st.LM)
    inner = st.G @ Minv
    inner = 0.5 * (inner + jnp.swapaxes(inner, -1, -2))

    q, n = lam.shape
    n_blocks, pad = _pad_blocks(n, n_chunk)
    xs_p = jnp.concatenate(
        [xs, jnp.broadcast_to(xs[:1], (pad,) + xs.shape[1:])]) \
        if pad else xs
    lam_p = jnp.concatenate(
        [lam, jnp.ones((q, pad), lam.dtype)], axis=1) if pad else lam
    b_p = jnp.concatenate(
        [b, jnp.zeros((q, pad), b.dtype)], axis=1) if pad else b
    xs_blk = xs_p.reshape((n_blocks, n_chunk) + xs.shape[1:])
    lam_blk = jnp.moveaxis(lam_p.reshape(q, n_blocks, n_chunk), 1, 0)
    b_blk = jnp.moveaxis(b_p.reshape(q, n_blocks, n_chunk), 1, 0)
    amp = lLmb0.astype(jnp.float64).astype(dt)
    s_dt = st.s.astype(dt)

    def body(_, blk):
        xs_b, lam_b, b_b = blk
        Knm = gram_stack(xs_b, z, lLmb, lLmb0, lnug, same=False,
                         compute_dtype=compute_dtype, kind=kernel)
        W = jnp.swapaxes(
            linalg.solve_tri_lower(st.Lmm, jnp.swapaxes(Knm, -1, -2)),
            -1, -2)
        q_diag = jnp.sum(jnp.square(W), axis=-1)
        c_diag = amp[:, None] * jnp.ones_like(q_diag)
        lam_dt = lam_b.astype(dt)
        lam_t = jnp.maximum(
            lam_dt + jnp.maximum(c_diag - q_diag, 0.0),
            jnp.asarray(1e-10, dtype=dt))
        u_b = (lam_dt * b_b.astype(dt)
               - jnp.einsum('qnm,qm->qn', W, s_dt)) / lam_t
        return None, u_b

    _, u_blocks = jax.lax.scan(body, None, (xs_blk, lam_blk, b_blk))
    u = jnp.moveaxis(u_blocks, 0, 1).reshape(q, n_blocks * n_chunk)[:, :n]
    return FitcAux(Lmm=st.Lmm, alpha=alpha, inner=inner, u=u)


@partial(jax.jit, static_argnames=("compute_dtype", "kernel"))
def predict_fitc_core(free: P.FreeParams, data, aux: FitcAux, z, x0s,
                      compute_dtype=None, kernel: str = "matern32"):
    """Latent predictive mean/var at x0s — O(n0 m) mean, O(n0 m^2) var."""
    lLmb, lLmb0, _, lnug = P.constrain(free)
    c00 = matern32_diag(x0s, lLmb0)                            # (q, n0)
    K0m = gram_stack(x0s, z, lLmb, lLmb0, lnug, same=False,
                     compute_dtype=compute_dtype, kind=kernel)  # (q, n0, m)
    W0 = jnp.swapaxes(
        linalg.solve_tri_lower(aux.Lmm, jnp.swapaxes(K0m, -1, -2)), -1, -2)
    ghat = jnp.einsum('qam,qm->qa', W0, aux.alpha)
    red = jnp.einsum('qam,qmk,qak->qa', W0, aux.inner, W0)
    gvar = c00.astype(red.dtype) - red
    # negative entries are a bad-inducing-set symptom; the model layer
    # clamps AND counts them (health_check surfaces the stats) instead of
    # hiding the clamp here (round-2 review weak #8)
    return ghat, gvar


def clamp_variance(gvar):
    """Clamp negative predictive variances to zero, returning the clamped
    array plus (count, worst) clamp statistics as device scalars."""
    neg = gvar < 0.0
    count = jnp.sum(neg)
    worst = jnp.min(jnp.where(neg, gvar, jnp.zeros_like(gvar)))
    return jnp.maximum(gvar, 0.0), count, worst
