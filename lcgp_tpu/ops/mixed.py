"""Mixed-precision factorization: f32 compute + f64 refinement.

The classic mixed-precision recipe: factor in f32, then recover f64
accuracy with a Newton-type correction whose only heavy ops are f64 GEMMs.
It pays where f64 factorizations and triangular solves are far slower than
f64 GEMMs, which was the case on the hardware this layer was built for;
whether it pays on the H100 is not measured yet (ROADMAP Q1.4).

Cholesky refinement (one step):
    L0 = chol_f32(B)
    R  = B - L0 L0^T                       (f64 GEMM — the exact residual)
    X  = L0^{-1} R L0^{-T}                 (f32 GEMMs against the blocked
                                            triangular inverse: X is
                                            O(eps32) so f32 relative error
                                            on it is second-order)
    L  = L0 + L0 Phi(X),  Phi = tril - diag/2
giving ||L L^T - B|| = O(eps32^2 cond) + O(eps64); a second step hits the
f64 floor.  Requires cond(B) * eps32 < 1 (cond below ~1e7) — true for the
loss targets here, whose factorands have unit-plus diagonals
(B = I + D C, C + Lam).

Inverse refinement (Newton/Hotelling-Bodewig):
    X_{k+1} = X_k (2I - B X_k)             (two f64 GEMMs per step)
seeded with the f32 potri inverse; error squares per step.
"""
from __future__ import annotations

import jax.numpy as jnp

from . import linalg

DEFAULT_REFINE_STEPS = 2


def parse_refine(compute_dtype):
    """Refine-step count from the mixed sentinel, or None if not mixed.

    'mixed' -> DEFAULT_REFINE_STEPS; 'mixed:N' -> N (the adaptive
    escalation path encodes the step count in the static dtype sentinel so
    jit caches key on it).
    """
    if not isinstance(compute_dtype, str):
        return None
    if compute_dtype == 'mixed':
        return DEFAULT_REFINE_STEPS
    if compute_dtype.startswith('mixed:'):
        return int(compute_dtype.split(':', 1)[1])
    return None


def is_mixed(compute_dtype):
    return parse_refine(compute_dtype) is not None


def _phi_lower(X):
    """tril(X) - diag(X)/2: the Cholesky-correction projector."""
    lower = jnp.tril(X)
    d = jnp.diagonal(X, axis1=-2, axis2=-1)
    n = X.shape[-1]
    eye = jnp.eye(n, dtype=X.dtype)
    return lower - 0.5 * d[..., :, None] * eye


def cholesky_mixed(B, refine_steps: int = 2, seed_jitter: float = 0.0):
    """f64-grade lower Cholesky of PSD B (f64) via f32 factor + refinement.

    seed_jitter: relative diagonal boost for the f32 *seed* factorization
    only (use when the target is near the f32 conditioning edge) — the
    refinement corrects toward the true, un-jittered B.
    """
    B32 = B.astype(jnp.float32)
    if seed_jitter:
        d = jnp.diagonal(B32, axis1=-2, axis2=-1)
        n = B.shape[-1]
        B32 = B32 + (seed_jitter * d)[..., :, None] * \
            jnp.eye(n, dtype=jnp.float32)
    L = jnp.linalg.cholesky(B32).astype(B.dtype)
    for _ in range(refine_steps):
        # exact residual: the one f64 product per step.  L is lower
        # triangular, so the structured syrk costs n^3/3 flops instead of
        # the dense 2n^3 XLA would emit.
        R = B - linalg.syrk_tri_lower(L)               # f64 strip GEMMs
        L32 = L.astype(jnp.float32)
        # X = L^{-1} R L^{-T} via the GEMM-blocked triangular inverse, NOT
        # two n-RHS triangular solves: XLA's TriangularSolveExpander
        # unrolls an n/128-step blocked substitution whose partial-update
        # buffers can stay live simultaneously (an out-of-memory at
        # n=12288 on earlier hardware).  M is one f32 n^2 buffer, and
        # every correction GEMM exploits triangular structure (f32 rounding on X is second-order in the refinement
        # either way):  M @ R is a trmm (n^3 vs 2n^3); only tril(X) is
        # ever read (the projector), so the right product fills just the
        # block-lower triangle (n^3/3); L @ Phi(X) is lower x lower
        # (2n^3/3).  Net: ~2n^3 f32 flops per step instead of 6n^3.
        M = linalg.tri_inverse_lower(L32)
        Y = linalg.trmm_lower(M, R.astype(jnp.float32))
        X = linalg.mul_t_block_lower(Y, M)
        corr = linalg.mul_lower_lower(L32, _phi_lower(X)).astype(B.dtype)
        L = L + corr
    return L


def chol_inverse_mixed(B, L64=None, newton_steps: int = 1):
    """f64-grade B^{-1} from an f32 potri seed + Newton steps (f64 GEMMs).

    L64: optional refined factor — used only for its f32 cast as the seed
    factor (saves the f32 cholesky when the caller already has one).
    """
    L32 = (jnp.linalg.cholesky(B.astype(jnp.float32)) if L64 is None
           else L64.astype(jnp.float32))
    X = linalg.chol_inverse(L32).astype(B.dtype)
    for _ in range(newton_steps):
        # X <- X (2I - B X): error contracts quadratically
        BX = B @ X                                     # f64 GEMM
        X = 2.0 * X - X @ BX                           # f64 GEMM
        X = 0.5 * (X + jnp.swapaxes(X, -1, -2))
    return X


def chol_inverse_from_factor_mixed(L64, newton_steps: int = 1):
    """f64-grade (L L^T)^{-1} from a refined f64 factor, GEMM-dominant.

    Seeds with the f32 potri inverse of the factor's f32 cast, then runs
    Newton/Hotelling-Bodewig steps X <- X (2I - B X) with B applied as
    L (L^T X) — three f64 GEMMs per step, no B reconstruction.

    The residual contracts quadratically from e0 ~ eps32*cond: one step
    reaches ~e0^2 (f64 floor for cond <~ 1e3), two steps ~e0^4 (floor for
    cond <~ 3e5).  newton_steps=0 returns the f32 potri seed cast to the
    factor dtype (error ~eps32*cond) — the 'mixed' default: gradients at
    f32 grade, since f64 Newton GEMMs on the (q, n, n) stack would cost as
    much as the f64 path.  The likelihood VJPs
    always use newton_steps=0 (the f32 contraction passes downstream set
    the gradient's error floor anyway — Newton on the inverse cannot
    lower it); 'mixed:N' escalation tightens the FORWARD refinement
    only, where the loss carries the 1e-8 accuracy criterion.
    """
    L32 = L64.astype(jnp.float32)
    X = linalg.chol_inverse(L32).astype(L64.dtype)
    Lt = jnp.swapaxes(L64, -1, -2)
    for _ in range(newton_steps):
        BX = L64 @ (Lt @ X)                            # two f64 GEMMs
        X = 2.0 * X - X @ BX                           # one f64 GEMM
        X = 0.5 * (X + jnp.swapaxes(X, -1, -2))
    return X


def cho_solve_vec_refined(L64, B, v, refine_steps: int = 2):
    """(B)^{-1} v via the f32 cast of the factor + f64 residual refinement.

    Heavy ops are f32 triangular vector solves and f64 matvecs (n^2).
    """
    L32 = L64.astype(jnp.float32)

    def solve32(r):
        return linalg.cho_solve_vec(L32, r.astype(jnp.float32)).astype(B.dtype)

    x = solve32(v)
    for _ in range(refine_steps):
        r = v - jnp.einsum('...nm,...m->...n', B, x)   # f64 matvec
        x = x + solve32(r)
    return x
