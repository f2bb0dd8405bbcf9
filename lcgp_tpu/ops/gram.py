"""Gram-stack construction and its analytic VJP.

All paths are jnp: XLA fuses the d-loop, the exp and the diagonal
epilogue of the batched Matérn build into one elementwise pass, and a
hand-written kernel for it (since deleted) tied that end to end on earlier
hardware; the Gram build is not measured on the H100 yet (ROADMAP Q1.2).
What survives of that kernel is the *algebraic* fusion it motivated:
`gram_factor_target` builds the factorization target directly, and the
loss forwards recover C-products from solve identities, so C is never
materialized separately from B.
"""
from __future__ import annotations

import jax.numpy as jnp

from .matern import matern32_gram


def gram_stack(x1, x2, lengthscales, amplitudes, nuggets, *, same: bool,
               compute_dtype=None, kind: str = 'matern32',
               want_c0: bool = False):
    """Batched Gram stack with optional compute-dtype override.

    kind='matern32' (the reference's kernel, default) or 'rbf' (separable
    squared-exponential extra).  compute_dtype=None keeps the input dtype
    (float64 parity path); jnp.float32 selects the fast f32 path; the
    'mixed' sentinel builds in f64 (factorizations downstream switch to
    ops/mixed).

    want_c0=True additionally returns the kernel's raw correlation stack
    (before the nugget/amplitude epilogue) for reuse by :func:`gram_vjp` —
    the custom-VJP losses compute their gradient contractions in the
    forward where C0 is live, skipping the rebuild (d elementwise passes
    and one exp over the (q, n, n) stack).
    """
    from .mixed import is_mixed
    if is_mixed(compute_dtype):
        compute_dtype = None
    if compute_dtype is not None:
        dt = jnp.dtype(compute_dtype)
        x1 = jnp.asarray(x1, dtype=dt)
        x2 = jnp.asarray(x2, dtype=dt)
        lengthscales = jnp.asarray(lengthscales, dtype=dt)
        amplitudes = jnp.asarray(amplitudes, dtype=dt)
        nuggets = jnp.asarray(nuggets, dtype=dt)

    if kind == 'rbf':
        # SE factors through a batched matmul
        from .rbf import rbf_gram
        return rbf_gram(x1, x2, lengthscales, amplitudes, nuggets, same=same,
                        want_c0=want_c0)
    if kind == 'matern52':
        from .matern52 import matern52_gram
        return matern52_gram(x1, x2, lengthscales, amplitudes, nuggets,
                             same=same, want_c0=want_c0)
    if kind != 'matern32':
        raise ValueError(f"unknown kernel kind {kind!r}")
    return matern32_gram(x1, x2, lengthscales, amplitudes, nuggets, same=same,
                         want_c0=want_c0)


def gram_factor_target(x, lengthscales, amplitudes, nuggets, *, row_scale,
                       diag_vec, compute_dtype=None, kind: str = 'matern32',
                       want_c0: bool = False):
    """Factorization target B = row_scale_k * C_k(x, x) + diag(diag_vec_k).

    row_scale (q,), diag_vec (q, n).  XLA fuses the scale/diag epilogue
    into the Gram build (verified at parity with an explicit Pallas
    fusion — see module docstring).  want_c0=True returns (B, C0) — see
    :func:`gram_stack`.
    """
    from .mixed import is_mixed
    if is_mixed(compute_dtype):
        compute_dtype = None
    from . import linalg
    C = gram_stack(x, x, lengthscales, amplitudes, nuggets, same=True,
                   compute_dtype=compute_dtype, kind=kind, want_c0=want_c0)
    c0 = None
    if want_c0:
        C, c0 = C
    B = linalg.add_diag(
        jnp.asarray(row_scale, dtype=C.dtype)[:, None, None] * C,
        jnp.asarray(diag_vec, dtype=C.dtype))
    return (B, c0) if want_c0 else B


def gram_vjp(x1, x2, lengthscales, amplitudes, nuggets, *, same: bool,
             cbar, kind: str = 'matern32', c0=None):
    """Analytic (glens, gamp, gnug) for a Gram-stack cotangent ``cbar``.

    Used by the custom-VJP loss paths; one (n1,n2) temporary per d-step
    instead of autodiff's residual chain.  x carries no gradient (data).
    ``c0``: the raw correlation stack from ``gram_stack(want_c0=True)`` —
    when given, the rebuild (incl. the exp) is skipped.
    """
    if kind == 'rbf':
        from .rbf import rbf_gram_vjp
        return rbf_gram_vjp(x1, x2, lengthscales, amplitudes, nuggets,
                            same=same, cbar=cbar, c0=c0)
    if kind == 'matern52':
        from .matern52 import matern52_gram_vjp
        return matern52_gram_vjp(x1, x2, lengthscales, amplitudes, nuggets,
                                 same=same, cbar=cbar, c0=c0)
    if kind != 'matern32':
        raise ValueError(f"unknown kernel kind {kind!r}")
    from .matern import matern32_gram_vjp
    return matern32_gram_vjp(x1, x2, lengthscales, amplitudes, nuggets,
                             same=same, cbar=cbar, c0=c0)
