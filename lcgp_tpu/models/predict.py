"""Predictive distributions.

``compute_aux_*`` are pure functions of (params, data); the model layer
recomputes them whenever parameters change — by construction there is no
stale-cache hazard (the reference recomputes only when its NaN sentinel is
set, SURVEY §3.5.1).

eigh/explicit-inverse free (DESIGN.md):

- full path (reference lcgp.py:685-726): store L_Bk = chol(I + D_k C_k);
  mean solve is (I + D_k C_k)^{-1} B_k, and the posterior variance uses
  Th_k^2 = D_k (I + D_k C_k)^{-1}, i.e. one triangular solve per test block.
- rep path (reference lcgp.py:728-803): T_k = (C_k + (d_k R)^{-1})^{-1}
  (matrix-inversion-lemma form of C^{-1} - C^{-1}(C^{-1}+d_k R)^{-1}C^{-1}),
  so store L_Tk = chol(C_k + diag(1/(d_k r))) — the reference's two explicit
  inverses (tf.linalg.inv at lcgp.py:787) disappear.

Memory-bounded chunking (q_chunk): unlike the losses — whose lax.map chunking
must live *inside* the one program the optimizer loop jits — the aux/predict
cores are dispatched from the host, so chunking here is a Python loop over a
single per-chunk compiled program (traced component offset, so every chunk
hits the same executable) with device-side concatenation.  The lax.map form
was dropped because its while-loop accumulator for a stacked
(chunks, qc, n, n) output let XLA pick a batch-minor layout that padded
every (qc, n, n) temporary; not re-measured on the H100 (ROADMAP Q1.3).
Under an outer trace (e.g. the serving fused executable) the host loop
simply unrolls.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops import linalg
from ..ops.gram import gram_stack
from ..ops.matern import matern32_diag
from . import params as P
from .likelihood import FullData, RepData, _bmv, _factor, _factor_solve_vec


class FullAux(NamedTuple):
    CinvM: jnp.ndarray   # (q, n)
    LB: jnp.ndarray      # (q, n, n) chol(I + D_k C_k)


class RepAux(NamedTuple):
    CinvM: jnp.ndarray   # (q, n)
    LT: jnp.ndarray      # (q, n, n) chol(C_k + diag(1/(d_k r)))
    mks: jnp.ndarray     # (q, n) training-point latent means (diagnostic,
                         # reference lcgp.py:779,800)
    psi_c: jnp.ndarray   # (q, p) Phi^T Sigma^{-1/2}_used (diagnostic; the
                         # reference's version broadcasts incorrectly when
                         # q != p, lcgp.py:754 — fixed here)


def _chunk_slices(q: int, q_chunk: int | None):
    """Validated [(offset, size)] chunk plan; None means one fused batch."""
    if q_chunk is None or q_chunk >= q:
        return None
    if q % q_chunk:
        raise ValueError(f'q_chunk={q_chunk} must divide q={q}')
    return list(range(0, q, q_chunk))


def _cat(chunks):
    """Concatenate per-chunk output tuples along the component axis."""
    return tuple(jnp.concatenate([c[i] for c in chunks], axis=0)
                 for i in range(len(chunks[0])))


# ---------------------------------------------------------------------------
# full path
# ---------------------------------------------------------------------------


def _full_b(free: P.FreeParams, data: FullData):
    """(q, n) weighted-data vectors B_k^T (reference lcgp.py:697)."""
    _, _, lsig_g, _ = P.constrain(free)
    lsig = P.expand_sigma(lsig_g, data.sigma_map)
    sigma = jnp.exp(lsig)
    return ((data.ys.T / jnp.sqrt(sigma)[None, :]) @ data.phi).T


@partial(jax.jit, static_argnames=("qc", "compute_dtype", "jitter", "kernel"))
def _aux_full_chunk(free: P.FreeParams, data: FullData, i0, *, qc: int,
                    compute_dtype, jitter: float, kernel: str):
    lLmb, lLmb0, _, lnug = P.constrain(free)
    b = _full_b(free, data)

    def sl(a):
        return jax.lax.dynamic_slice_in_dim(a, i0, qc, axis=0)

    lLmb_c, lLmb0_c, lnug_c, D_c, b_c = (sl(lLmb), sl(lLmb0), sl(lnug),
                                         sl(data.diag_D), sl(b))
    C = gram_stack(data.xs, data.xs, lLmb_c, lLmb0_c, lnug_c, same=True,
                   compute_dtype=compute_dtype, kind=kernel)
    Bmat = linalg.add_diag(D_c[:, None, None].astype(C.dtype) * C,
                           1.0 + jitter)
    LB = _factor(Bmat, compute_dtype)
    CinvM = _factor_solve_vec(LB, Bmat, b_c.astype(LB.dtype),
                              compute_dtype)                    # (qc, n)
    return CinvM, LB


def compute_aux_full(free: P.FreeParams, data: FullData,
                     compute_dtype=None, jitter: float = 0.0,
                     kernel: str = "matern32",
                     q_chunk: int | None = None) -> FullAux:
    q = int(data.phi.shape[1])
    offsets = _chunk_slices(q, q_chunk)
    if offsets is None:
        offsets = [0]
        q_chunk = q
    chunks = [_aux_full_chunk(free, data, i0, qc=q_chunk,
                              compute_dtype=compute_dtype, jitter=jitter,
                              kernel=kernel)
              for i0 in offsets]
    CinvM, LB = _cat(chunks) if len(chunks) > 1 else chunks[0]
    return FullAux(CinvM=CinvM, LB=LB)


@partial(jax.jit, static_argnames=("qc", "compute_dtype", "jitter", "kernel"))
def _pred_full_chunk(free: P.FreeParams, data: FullData, aux: FullAux, x0s,
                     i0, *, qc: int, compute_dtype, jitter: float,
                     kernel: str):
    lLmb, lLmb0, _, lnug = P.constrain(free)
    c00 = matern32_diag(x0s, lLmb0)                             # (q, n0)

    def sl(a):
        return jax.lax.dynamic_slice_in_dim(a, i0, qc, axis=0)

    lLmb_c, lLmb0_c, lnug_c, D_c = (sl(lLmb), sl(lLmb0), sl(lnug),
                                    sl(data.diag_D))
    c00_c, CinvM_c, LB_c = sl(c00), sl(aux.CinvM), sl(aux.LB)
    c0 = gram_stack(x0s, data.xs, lLmb_c, lLmb0_c, lnug_c, same=False,
                    compute_dtype=compute_dtype, kind=kernel)   # (qc,n0,n)
    ghat = _bmv(c0, CinvM_c)
    M = linalg.solve_tri_lower(LB_c, jnp.swapaxes(c0, -1, -2))
    gvar = c00_c.astype(M.dtype) - D_c[:, None].astype(M.dtype) * \
        jnp.sum(jnp.square(M), axis=-2)
    return ghat, gvar


def predict_full_core(free: P.FreeParams, data: FullData, aux: FullAux, x0s,
                      compute_dtype=None, jitter: float = 0.0,
                      kernel: str = "matern32", q_chunk: int | None = None):
    """Latent predictive mean/var at standardized x0s.  Returns (ghat, gvar),
    each (q, n0)."""
    q = int(data.phi.shape[1])
    offsets = _chunk_slices(q, q_chunk)
    if offsets is None:
        offsets = [0]
        q_chunk = q
    chunks = [_pred_full_chunk(free, data, aux, x0s, i0, qc=q_chunk,
                               compute_dtype=compute_dtype, jitter=jitter,
                               kernel=kernel)
              for i0 in offsets]
    return _cat(chunks) if len(chunks) > 1 else chunks[0]


@jax.jit
def recombine_full(free: P.FreeParams, data: FullData, ghat, gvar, ymean, ystd):
    """Latent -> output space (reference predict_full, lcgp.py:840-848)."""
    _, _, lsig_g, _ = P.constrain(free)
    lsig = P.expand_sigma(lsig_g, data.sigma_map)
    sigma = jnp.exp(lsig)

    psi = data.phi.T * jnp.sqrt(sigma)[None, :]                 # (q, p)
    predmean = psi.T @ ghat                                     # (p, n0)
    confvar = gvar.T @ jnp.square(psi)                          # (n0, p)
    predvar = confvar + sigma[None, :]

    ypred = predmean * ystd + ymean
    yconfvar = confvar.T * jnp.square(ystd)
    ypredvar = predvar.T * jnp.square(ystd)
    return ypred, ypredvar, yconfvar


@jax.jit
def fullcov_full(free: P.FreeParams, data: FullData, gvar, ystd):
    """(n0, p, p) full predictive covariance (reference lcgp.py:850-857)."""
    _, _, lsig_g, _ = P.constrain(free)
    lsig = P.expand_sigma(lsig_g, data.sigma_map)
    sigma = jnp.exp(lsig)
    psi = data.phi.T * jnp.sqrt(sigma)[None, :]                 # (q, p)

    CH = jnp.einsum('kn,kp->npk', jnp.sqrt(gvar), psi)          # (n0, p, q)
    cov = CH @ jnp.swapaxes(CH, -1, -2)
    cov = cov + jnp.diag(sigma)[None, :, :]
    ystd_vec = ystd[:, 0]
    return cov * (ystd_vec[:, None] * ystd_vec[None, :])[None, :, :]


# ---------------------------------------------------------------------------
# rep path
# ---------------------------------------------------------------------------


def _rep_b(free: P.FreeParams, data: RepData):
    """(q, n) dual data vectors b_k (reference lcgp.py:606-610)."""
    _, _, lsig_g, _ = P.constrain(free)
    lsig = P.expand_sigma(lsig_g, data.sigma_map)
    sigma_raw = jnp.exp(lsig)
    sigma_inv_sqrt = data.scale / jnp.sqrt(sigma_raw)           # (p,)
    v = data.phi * sigma_inv_sqrt[:, None]                      # (p, q)
    return data.r[None, :] * (data.ybar.T @ v).T                # (q, n)


@partial(jax.jit, static_argnames=("qc", "compute_dtype", "jitter", "kernel"))
def _aux_rep_chunk(free: P.FreeParams, data: RepData, i0, *, qc: int,
                   compute_dtype, jitter: float, kernel: str):
    lLmb, lLmb0, _, lnug = P.constrain(free)
    b = _rep_b(free, data)
    r = data.r

    def sl(a):
        return jax.lax.dynamic_slice_in_dim(a, i0, qc, axis=0)

    lLmb_c, lLmb0_c, lnug_c, D_c, b_c = (sl(lLmb), sl(lLmb0), sl(lnug),
                                         sl(data.diag_D), sl(b))
    C = gram_stack(data.xs, data.xs, lLmb_c, lLmb0_c, lnug_c, same=True,
                   compute_dtype=compute_dtype, kind=kernel)
    D = D_c.astype(C.dtype)
    # LT = chol(C + diag(1/(D r))): shared by dual weights and
    # variances.  Jitter formula matches the training loss
    # (_rep_terms_fwd_impl) so the predictive factor is the same
    # regularized system the hyperparameters were optimized against.
    lam = 1.0 / (D[:, None] * r[None, :])                       # (qc, n)
    jit_d = jitter * (1.0 + lLmb0_c.astype(C.dtype)[:, None])
    A = linalg.add_diag(C, lam + jit_d)
    LT = _factor(A, compute_dtype)
    CinvM = _factor_solve_vec(LT, A, (lam * b_c).astype(LT.dtype),
                              compute_dtype)
    # training-point latent means m = S b = C @ CinvM (diagnostic,
    # reference lcgp.py:779)
    m = _bmv(C, CinvM)
    return CinvM, LT, m


def compute_aux_rep(free: P.FreeParams, data: RepData,
                    compute_dtype=None, jitter: float = 0.0,
                    kernel: str = "matern32",
                    q_chunk: int | None = None) -> RepAux:
    """Rep-path predictive aux via the classic GP system.

    The reference computes the dual weights by Woodbury cancellation,
    ``CinvM = b - d R m`` (lcgp.py:781) — numerically catastrophic when the
    fitted amplitude is large (the cancellation loses ~log10(amp * n)
    digits).  The identity

        (I + D R C)^{-1} b  =  (C + (D R)^{-1})^{-1} (D R)^{-1} b

    turns it into one cancellation-free solve against the same
    ``C + diag(1/(D r))`` factor the variances need — one Cholesky total.
    """
    q = int(data.phi.shape[1])
    offsets = _chunk_slices(q, q_chunk)
    if offsets is None:
        offsets = [0]
        q_chunk = q
    chunks = [_aux_rep_chunk(free, data, i0, qc=q_chunk,
                             compute_dtype=compute_dtype, jitter=jitter,
                             kernel=kernel)
              for i0 in offsets]
    CinvM, LT, m = _cat(chunks) if len(chunks) > 1 else chunks[0]
    return RepAux(CinvM=CinvM, LT=LT, mks=m, psi_c=_rep_psi_c(free, data))


@jax.jit
def _rep_psi_c(free: P.FreeParams, data: RepData):
    _, _, lsig_g, _ = P.constrain(free)
    lsig = P.expand_sigma(lsig_g, data.sigma_map)
    sigma_inv_sqrt = data.scale / jnp.sqrt(jnp.exp(lsig))
    return data.phi.T * sigma_inv_sqrt[None, :]                 # (q, p)


@partial(jax.jit, static_argnames=("qc", "compute_dtype", "jitter", "kernel"))
def _pred_rep_chunk(free: P.FreeParams, data: RepData, aux: RepAux, x0s,
                    i0, *, qc: int, compute_dtype, jitter: float,
                    kernel: str):
    lLmb, lLmb0, _, lnug = P.constrain(free)
    c00 = matern32_diag(x0s, lLmb0)

    def sl(a):
        return jax.lax.dynamic_slice_in_dim(a, i0, qc, axis=0)

    lLmb_c, lLmb0_c, lnug_c = sl(lLmb), sl(lLmb0), sl(lnug)
    c00_c, CinvM_c, LT_c = sl(c00), sl(aux.CinvM), sl(aux.LT)
    c0 = gram_stack(x0s, data.xs, lLmb_c, lLmb0_c, lnug_c, same=False,
                    compute_dtype=compute_dtype, kind=kernel)
    ghat = _bmv(c0, CinvM_c)
    M = linalg.solve_tri_lower(LT_c, jnp.swapaxes(c0, -1, -2))
    gvar = c00_c.astype(M.dtype) - jnp.sum(jnp.square(M), axis=-2)
    return ghat, gvar


def predict_rep_core(free: P.FreeParams, data: RepData, aux: RepAux, x0s,
                     compute_dtype=None, jitter: float = 0.0,
                     kernel: str = "matern32", q_chunk: int | None = None):
    q = int(data.phi.shape[1])
    offsets = _chunk_slices(q, q_chunk)
    if offsets is None:
        offsets = [0]
        q_chunk = q
    chunks = [_pred_rep_chunk(free, data, aux, x0s, i0, qc=q_chunk,
                              compute_dtype=compute_dtype, jitter=jitter,
                              kernel=kernel)
              for i0 in offsets]
    return _cat(chunks) if len(chunks) > 1 else chunks[0]


@jax.jit
def recombine_rep(free: P.FreeParams, data: RepData, ghat, gvar,
                  ybar_mean, ybar_std):
    """Latent -> output space, rep variant (reference lcgp.py:902-926).

    ``data.scale`` already encodes rep_standardize_ybar; un-standardization
    multiplies by ybar_std only when it was applied (scale != 1), which the
    caller passes as ybar_mean/ybar_std or zeros/ones.
    """
    _, _, lsig_g, _ = P.constrain(free)
    lsig = P.expand_sigma(lsig_g, data.sigma_map)
    sigma_raw = jnp.exp(lsig)

    sigma_sqrt_used = jnp.sqrt(sigma_raw) / data.scale
    sigma_var_used = sigma_raw / jnp.square(data.scale)

    Psi = data.phi * sigma_sqrt_used[:, None]                   # (p, q)
    predmean_used = Psi @ ghat                                  # (p, n0)
    confvar_used = jnp.square(Psi) @ gvar
    predvar_used = confvar_used + sigma_var_used[:, None]

    ypred = predmean_used * ybar_std + ybar_mean
    yconfvar = confvar_used * jnp.square(ybar_std)
    ypredvar = predvar_used * jnp.square(ybar_std)
    return ypred, ypredvar, yconfvar
