"""Negative log marginal posterior — the training objectives.

Pure jitted functions of (FreeParams, data).  Mathematical contract is the
reference's two losses (``neglpost`` lcgp.py:635-666, ``neglpost_rep``
lcgp.py:554-630); see DESIGN.md for the eigh→Cholesky reformulation (values
agree to fp tolerance; the decompositions differ but every term is
basis-invariant).

Structure: the per-component loop becomes a (q,n,n) Gram stack plus
batched Cholesky/solves — no Python-level q loop, no joblib.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops import linalg
from ..ops import mixed as mixed_ops
from ..ops.gram import gram_factor_target, gram_vjp


def _factor(B, compute_dtype):
    """Cholesky of the factorization target, honoring precision='mixed'
    ('mixed' or 'mixed:N' — N refinement steps, adaptive escalation)."""
    steps = mixed_ops.parse_refine(compute_dtype)
    if steps is not None:
        return mixed_ops.cholesky_mixed(B, refine_steps=steps,
                                        seed_jitter=1e-6)
    return linalg.cholesky(B)


def _factor_solve_vec(L, B, v, compute_dtype):
    steps = mixed_ops.parse_refine(compute_dtype)
    if steps is not None:
        return mixed_ops.cho_solve_vec_refined(L, B, v, refine_steps=steps)
    return linalg.cho_solve_vec(L, v)


def _factor_inverse(L, compute_dtype):
    """(L L^T)^{-1} for the loss VJPs.

    'mixed' = f64-grade LOSS (refined forward — line searches see true
    f64 objective resolution) + f32-grade GRADIENTS: the bwd inverse is
    the f32 potri seed alone (error ~eps32*cond), because f64 Newton
    steps on the inverse would cost as much as the f64 path they are
    meant to undercut."""
    if mixed_ops.is_mixed(compute_dtype):
        # seed-only: the gradient's error floor is set by the f32
        # contraction passes (Cbar/gram_vjp), which Newton steps on the
        # inverse cannot lower.  'mixed:N' escalation therefore tightens
        # only the FORWARD refinement (the loss, which has the 1e-8
        # criterion).
        return mixed_ops.chol_inverse_from_factor_mixed(L, newton_steps=0)
    return linalg.chol_inverse(L)


def _use_inv_flow(compute_dtype, dt) -> bool:
    """True when the loss terms run the f64 inverse flow.

    f64: the forward computes ``Linv = L^{-1}`` explicitly and gets the
    dual vector by two batched matvecs; the gradient pass (also in the
    forward — see the gradient-in-forward note below) reuses ``Linv`` so
    its potri needs only the ``Linv^T Linv`` combination GEMM, instead of
    a latency-bound 1-rhs substitution plus a separate inverse.

    f32 keeps the substitution flow.  Mixed keeps it too (the refined
    solve is part of the f64-grade loss contract).  Both routings were
    chosen on earlier hardware and are not measured on the H100
    (ROADMAP Q1.3).
    """
    return (not mixed_ops.is_mixed(compute_dtype)) and dt == jnp.float64
from . import params as P


class FullData(NamedTuple):
    """Static training tensors for submethod='full'."""
    xs: jnp.ndarray        # (n, d) standardized inputs
    ys: jnp.ndarray        # (p, n) standardized outputs
    phi: jnp.ndarray       # (p, q)
    diag_D: jnp.ndarray    # (q,)
    sigma_map: jnp.ndarray  # (p,) int32 output-dim -> error group


class RepData(NamedTuple):
    """Static training tensors for submethod='rep'.

    ``scale`` encodes the rep_standardize_ybar toggle uniformly: it equals
    ``ybar_std`` when standardizing (so sigma2_used = sigma2/scale^2,
    reference lcgp.py:576-584) and ones otherwise, with ``ybar`` holding
    whichever Y matrix the loss actually consumes.
    """
    xs: jnp.ndarray        # (n, d) standardized unique inputs
    ybar: jnp.ndarray      # (p, n) replicate-averaged outputs (std'ized or raw)
    scale: jnp.ndarray     # (p,) ybar_std (or ones)
    r: jnp.ndarray         # (n,) float replicate counts
    phi: jnp.ndarray       # (p, q)
    diag_D: jnp.ndarray    # (q,)
    sigma_map: jnp.ndarray  # (p,) int32


def _bmv(mats, vecs):
    """Batched matrix-vector: (q,n,m) @ (q,m) -> (q,n)."""
    return jnp.einsum('qnm,qm->qn', mats, vecs)


def _map_components(body, stacks, q_chunk):
    """Apply ``body`` over the q leading axis in memory-bounded chunks.

    q_chunk=None runs one fused batch (fastest when the (q,n,n) stacks fit
    in HBM).  Otherwise the stacks are reshaped to (q/q_chunk, q_chunk, ...)
    and body is lax.map'ed chunk by chunk, bounding the per-chunk transients
    (Gram, B, inverse, cotangent) to q_chunk stacks.  The bodies are
    custom-VJP terms that compute their gradient primitives in the forward
    (gradient-in-forward — see the component-terms note below), so the
    residuals carried across chunks are O(q n) vectors, not (q,n,n)
    stacks, and the backward never recomputes the Gram build or the
    factorization.
    """
    if q_chunk is None:
        return body(stacks)
    q = jax.tree_util.tree_leaves(stacks)[0].shape[0]
    if q % q_chunk:
        raise ValueError(f'q_chunk={q_chunk} must divide q={q}')
    chunked = jax.tree_util.tree_map(
        lambda x: x.reshape((q // q_chunk, q_chunk) + x.shape[1:]), stacks)
    out = jax.lax.map(body, chunked)
    return jax.tree_util.tree_map(
        lambda x: x.reshape((q,) + x.shape[2:]), out)


# ---------------------------------------------------------------------------
# Custom-VJP component terms.
#
# Autodiff through the batched Cholesky keeps ~15-20 (q,n,n) residual
# buffers alive (measured: ~60GB at n=4096, q=20).  The loss gradients have
# closed forms that need only the factor and one solve:
#
#   full:  t = 0.5 logdet(B) - 0.5 a^T C B^{-1} a,   B = I + D C,  w = B^{-1}a
#          dt/dC = 0.5 D B^{-1} - 0.5 w w^T          (note C w = (a - w)/D)
#          dt/da = -C w
#   rep:   t = -0.5 b^T S b + 0.5 logdet(A),  A = I + D (sr sr^T (.) C).
#          With P = sqrt(D R) and Lam = (D R)^{-1}:  A = P (C + Lam) P, so
#          logdet A = sum_i log(D r_i) + logdet(C + Lam), and with
#          T = (C + Lam)^{-1}, u = T Lam b:
#            b^T S b = b^T C u,   dt/dC = 0.5 T - 0.5 u u^T,   dt/db = -C u
#          (u is also exactly the predictive dual weight vector CinvM).
#          This form avoids the reference's Woodbury cancellation
#          (lcgp.py:614-621) — catastrophic at large fitted amplitudes —
#          and shares one Cholesky between the loss and the predict path.
#
# GRADIENT-IN-FORWARD: each component's output is a scalar, so its
# cotangent ``tbar_k`` enters every gradient linearly — the whole
# contraction (inverse assembly, Gram cotangent, kernel VJP) can run in
# the custom-VJP *forward*, where the Gram's raw correlation stack C0 is
# still live (gram_vjp's rebuild — d elementwise passes + one exp — is
# skipped), and the backward is just per-component scaling by tbar.
# Residuals shrink from O(q n^2) (the stored factors) to O(q (n+d))
# gradient primitives, so lax.map chunking no longer accumulates (q,n,n)
# buffers across chunks at all.  For the full loss under
# jax.grad/value_and_grad (tbar = 1) the values are bitwise-identical to
# contracting in the backward; the rep loss divides by n, so its tbar is
# 1/n and the two forms agree to rounding only.
# ---------------------------------------------------------------------------


@partial(jax.custom_vjp, nondiff_argnums=(0, 1, 2))
def _full_terms(compute_dtype, jitter, kernel, xs, lLmb, lLmb0, lnug, D, a):
    terms, _ = _full_terms_fwd_impl(compute_dtype, jitter, kernel, xs,
                                    lLmb, lLmb0, lnug, D, a)
    return terms


def _full_terms_fwd_impl(compute_dtype, jitter, kernel, xs, lLmb, lLmb0,
                         lnug, D, a, want_grad: bool = False):
    # Build the factorization target B = D C + (1+jitter) I directly; C
    # itself is never materialized — the quad term uses the exact identity
    # C w = (a - (1+jitter) w) / D from B w = a.
    n = xs.shape[0]
    dt = jnp.asarray(xs).dtype if (compute_dtype is None or
                               mixed_ops.is_mixed(compute_dtype)) \
        else jnp.dtype(compute_dtype)
    diag_vec = jnp.full((D.shape[0], n), 1.0 + jitter, dtype=dt)
    built = gram_factor_target(xs, lLmb, lLmb0, lnug, row_scale=D,
                               diag_vec=diag_vec, compute_dtype=compute_dtype,
                               kind=kernel, want_c0=want_grad)
    B, C0 = built if want_grad else (built, None)
    if _use_inv_flow(compute_dtype, B.dtype):
        # f64: fused factor+inverse (the blocked Cholesky's diagonal-block
        # inverses feed the triangular inversion); w by two matvecs; the
        # gradient pass reuses Linv for its potri (see _use_inv_flow).
        LB, fac = linalg.cholesky_tri_inverse(B)
        w = _bmv(jnp.swapaxes(fac, -1, -2),
                 _bmv(fac, a.astype(LB.dtype)))
    else:
        LB = _factor(B, compute_dtype)
        fac = LB
        w = _factor_solve_vec(LB, B, a.astype(LB.dtype), compute_dtype)
    logdet = linalg.chol_logdet(LB)
    Dm = D.astype(LB.dtype)
    Cw = (a.astype(LB.dtype) - (1.0 + jitter) * w) / Dm[:, None]
    # n-length reductions accumulate in f64 (loss resolution at large n)
    quad = jnp.sum((a.astype(LB.dtype) * Cw).astype(jnp.float64), axis=-1)
    terms = 0.5 * logdet - 0.5 * quad
    if not want_grad:
        return terms, None
    # Gradient primitives (tbar-linear).  mixed: the (q,n,n) gradient work
    # (inverse cotangent assembly + kernel-VJP elementwise passes) runs in
    # f32 — see _factor_inverse; the inverse is seeded from the f32 cast
    # of the factor (value-identical to the old f32-stored residual).
    vdt = jnp.float32 if mixed_ops.is_mixed(compute_dtype) else LB.dtype
    if _use_inv_flow(compute_dtype, B.dtype):
        # fac is Linv (f64 flow): only the potri combination GEMM remains
        Binv = linalg.gram_tri_lower(fac).astype(vdt)
    else:
        fac_seed = fac.astype(jnp.float32) \
            if mixed_ops.is_mixed(compute_dtype) else fac
        Binv = _factor_inverse(fac_seed, compute_dtype).astype(vdt)
    w_v = w.astype(vdt)
    cbar0 = (0.5 * Dm.astype(vdt)[:, None, None] * Binv
             - 0.5 * w_v[:, :, None] * w_v[:, None, :])
    glens0, gamp0, gnug0 = gram_vjp(xs, xs, lLmb, lLmb0, lnug, same=True,
                                    cbar=cbar0, kind=kernel, c0=C0)
    abar0 = (-Cw).astype(a.dtype)
    return terms, (xs, D, glens0, gamp0, gnug0, abar0)


def _full_terms_vjp_fwd(compute_dtype, jitter, kernel, xs, lLmb, lLmb0,
                        lnug, D, a):
    return _full_terms_fwd_impl(compute_dtype, jitter, kernel, xs,
                                lLmb, lLmb0, lnug, D, a, want_grad=True)


def _full_terms_vjp_bwd(compute_dtype, jitter, kernel, res, tbar):
    xs, D, glens0, gamp0, gnug0, abar0 = res
    return (jnp.zeros_like(xs),
            tbar.astype(glens0.dtype)[:, None] * glens0,
            tbar.astype(gamp0.dtype) * gamp0,
            tbar.astype(gnug0.dtype) * gnug0,
            jnp.zeros_like(D),
            tbar.astype(abar0.dtype)[:, None] * abar0)


_full_terms.defvjp(_full_terms_vjp_fwd, _full_terms_vjp_bwd)


@partial(jax.custom_vjp, nondiff_argnums=(0, 1, 2))
def _rep_terms(compute_dtype, jitter, kernel, xs, sr, lLmb, lLmb0, lnug, D, b):
    terms, _ = _rep_terms_fwd_impl(compute_dtype, jitter, kernel, xs, sr,
                                   lLmb, lLmb0, lnug, D, b)
    return terms


def _rep_terms_fwd_impl(compute_dtype, jitter, kernel, xs, sr, lLmb, lLmb0,
                        lnug, D, b, want_grad: bool = False):
    dt = jnp.asarray(xs).dtype if (compute_dtype is None or
                               mixed_ops.is_mixed(compute_dtype)) \
        else jnp.dtype(compute_dtype)
    Dc = D.astype(dt)
    r2 = jnp.square(sr.astype(dt))                          # r
    lam = 1.0 / (Dc[:, None] * r2[None, :])                 # (q, n)
    # jitter scaled by the amplitude so the f32 path stays factorizable
    jit_d = jitter * (1.0 + lLmb0.astype(dt)[:, None])
    diag_vec = lam + jnp.broadcast_to(jit_d, lam.shape)
    # A = C + diag(lam + jit) built directly; C u recovers via
    # C u = lam b - (lam + jit) u from A u.
    ones = jnp.ones_like(Dc)
    built = gram_factor_target(xs, lLmb, lLmb0, lnug, row_scale=ones,
                               diag_vec=diag_vec, compute_dtype=compute_dtype,
                               kind=kernel, want_c0=want_grad)
    A, C0 = built if want_grad else (built, None)
    if _use_inv_flow(compute_dtype, A.dtype):
        # f64 fused factor+inverse-residual flow — see _use_inv_flow
        LT, fac = linalg.cholesky_tri_inverse(A)
        u = _bmv(jnp.swapaxes(fac, -1, -2),
                 _bmv(fac, lam * b.astype(dt)))
    else:
        LT = _factor(A, compute_dtype)
        fac = LT
        u = _factor_solve_vec(LT, A, lam * b.astype(dt), compute_dtype)
    chol_ld = linalg.chol_logdet(LT)
    Cu = lam * b.astype(dt) - diag_vec * u                  # S b
    logdetA = (jnp.sum(jnp.log(Dc[:, None] * r2[None, :])
                       .astype(jnp.float64), axis=-1)
               + chol_ld)
    terms = (-0.5 * jnp.sum((b.astype(dt) * Cu).astype(jnp.float64), axis=-1)
             + 0.5 * logdetA)
    if not want_grad:
        return terms, None
    # Gradient primitives (tbar-linear) — see _full_terms_fwd_impl
    vdt = jnp.float32 if mixed_ops.is_mixed(compute_dtype) else LT.dtype
    if _use_inv_flow(compute_dtype, A.dtype):
        Tinv = linalg.gram_tri_lower(fac).astype(vdt)      # (C + Lam)^{-1}
    else:
        fac_seed = fac.astype(jnp.float32) \
            if mixed_ops.is_mixed(compute_dtype) else fac
        Tinv = _factor_inverse(fac_seed, compute_dtype).astype(vdt)
    u_v = u.astype(vdt)
    cbar0 = 0.5 * Tinv - 0.5 * u_v[:, :, None] * u_v[:, None, :]
    glens0, gamp0, gnug0 = gram_vjp(xs, xs, lLmb, lLmb0, lnug, same=True,
                                    cbar=cbar0, kind=kernel, c0=C0)
    bbar0 = (-Cu).astype(b.dtype)
    return terms, (xs, sr, D, glens0, gamp0, gnug0, bbar0)


def _rep_terms_vjp_fwd(compute_dtype, jitter, kernel, xs, sr, lLmb, lLmb0,
                       lnug, D, b):
    return _rep_terms_fwd_impl(compute_dtype, jitter, kernel, xs, sr,
                               lLmb, lLmb0, lnug, D, b, want_grad=True)


def _rep_terms_vjp_bwd(compute_dtype, jitter, kernel, res, tbar):
    xs, sr, D, glens0, gamp0, gnug0, bbar0 = res
    return (jnp.zeros_like(xs), jnp.zeros_like(sr),
            tbar.astype(glens0.dtype)[:, None] * glens0,
            tbar.astype(gamp0.dtype) * gamp0,
            tbar.astype(gnug0.dtype) * gnug0,
            jnp.zeros_like(D),
            tbar.astype(bbar0.dtype)[:, None] * bbar0)


_rep_terms.defvjp(_rep_terms_vjp_fwd, _rep_terms_vjp_bwd)


@partial(jax.jit, static_argnames=("compute_dtype", "jitter", "q_chunk", "kernel"))
def neglpost_full(free: P.FreeParams, data: FullData,
                  compute_dtype=None, jitter: float = 0.0,
                  q_chunk: int | None = None, kernel: str = "matern32"):
    """Full-data integrated negative log marginal posterior (lcgp.py:635-666).

    Per component k (C_k the Matérn Gram, D_k = diag_D[k], a_k = Y^T psi_ck):
        + 0.5 * logdet(I + D_k C_k)
        - 0.5 * (C_k a_k)^T (I + D_k C_k)^{-1} a_k
    plus the noise terms  (n/2) sum_p lsigma2_p + 0.5 ||Y / sigma||_F^2.
    NOT divided by n (asymmetry vs the rep loss is the reference's own,
    SURVEY §3.5.6).
    """
    lLmb, lLmb0, lsig_g, lnug = P.constrain(free)
    lsig = P.expand_sigma(lsig_g, data.sigma_map)          # (p,)
    sigma = jnp.exp(lsig)
    n = data.xs.shape[0]

    psi_c = data.phi / jnp.sqrt(sigma)[:, None]            # (p, q)
    a = (data.ys.T @ psi_c).T                              # (q, n)

    def body(stacks):
        lLmb_c, lLmb0_c, lnug_c, D_c, a_c = stacks
        return _full_terms(compute_dtype, jitter, kernel, data.xs,
                           lLmb_c, lLmb0_c, lnug_c, D_c, a_c)  # (qc,)

    terms = _map_components(body, (lLmb, lLmb0, lnug, data.diag_D, a),
                            q_chunk)
    nlp = jnp.sum(terms).astype(data.ys.dtype)
    nlp += 0.5 * n * jnp.sum(lsig)
    nlp += 0.5 * jnp.sum(jnp.square(data.ys / jnp.sqrt(sigma)[:, None]))
    return nlp


@partial(jax.jit, static_argnames=("compute_dtype", "jitter", "q_chunk", "kernel"))
def neglpost_rep(free: P.FreeParams, data: RepData,
                 compute_dtype=None, jitter: float = 0.0,
                 q_chunk: int | None = None, kernel: str = "matern32"):
    """Replication negative log marginal on unique points (lcgp.py:554-630).

    Woodbury on A_k = I + d_k sqrt(r) C_k sqrt(r):
        S_k b = C b - C sqrt(d_k r) A_k^{-1} sqrt(d_k r) C b
    terms: -0.5 b_k^T S_k b_k + 0.5 logdet A_k; plus the diagonal data terms;
    total divided by n.
    """
    lLmb, lLmb0, lsig_g, lnug = P.constrain(free)
    lsig = P.expand_sigma(lsig_g, data.sigma_map)          # (p,)
    sigma_raw = jnp.exp(lsig)
    n = data.xs.shape[0]
    p = data.ybar.shape[0]
    r = data.r
    sr = jnp.sqrt(r)

    sigma_var_used = sigma_raw / jnp.square(data.scale)
    sigma_inv_sqrt = data.scale / jnp.sqrt(sigma_raw)      # (p,)

    nlp = 0.5 * jnp.sum(r * jnp.sum(jnp.square(data.ybar * sigma_inv_sqrt[:, None]),
                                    axis=0))
    nlp += 0.5 * n * jnp.sum(jnp.log(sigma_var_used))
    nlp += -0.5 * p * jnp.sum(jnp.log(r))

    v = data.phi * sigma_inv_sqrt[:, None]                 # (p, q)
    b = r[None, :] * (data.ybar.T @ v).T                   # (q, n)

    def body(stacks):
        lLmb_c, lLmb0_c, lnug_c, D_c, b_c = stacks
        return _rep_terms(compute_dtype, jitter, kernel, data.xs, sr,
                          lLmb_c, lLmb0_c, lnug_c, D_c, b_c)  # (qc,)

    terms = _map_components(body, (lLmb, lLmb0, lnug, data.diag_D, b),
                            q_chunk)
    nlp += jnp.sum(terms).astype(nlp.dtype)
    return nlp / n


def make_loss(submethod: str, data, compute_dtype=None, jitter: float = 0.0,
              q_chunk: int | None = None, kernel: str = 'matern32'):
    """Return loss(free_params) for the given submethod.

    The returned loss is an :class:`~lcgp_tpu.fit.auxloss.AuxLoss`: callable
    as a plain closure, but optimizers thread ``data`` through their jitted
    blocks as a runtime argument so the training tensors are never inlined
    into the compiled program as constants.
    """
    from ..fit.auxloss import AuxLoss
    if submethod == 'full':
        return AuxLoss(
            lambda free, data: neglpost_full(free, data,
                                             compute_dtype=compute_dtype,
                                             jitter=jitter, q_chunk=q_chunk,
                                             kernel=kernel), data)
    if submethod == 'rep':
        return AuxLoss(
            lambda free, data: neglpost_rep(free, data,
                                            compute_dtype=compute_dtype,
                                            jitter=jitter, q_chunk=q_chunk,
                                            kernel=kernel), data)
    raise ValueError("Invalid submethod. Choices are 'full' or 'rep'.")
