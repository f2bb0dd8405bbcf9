"""Squared-exponential (ARD RBF) kernel, batched over latent components.

An *extra* beyond the reference (which ships only Matérn 3/2,
covmat.py:5-55); the driver's north-star text names the separable
squared-exponential, so it is provided as ``kernel='rbf'``.

Nugget/amplitude semantics follow the reference's Matérn rules exactly
(SURVEY §3.5.9): ``eta = lnug/(1+lnug)``; ``amp * ((1-eta) C0 + eta I)``
when x1 ≡ x2, ``amp * (1-eta) C0`` for cross-covariances; prior variance
(diag) is just ``amp``.

Unlike the |u−v| product form, the SE exponent factors through a Gram
matmul — ``‖u−v‖² = ‖u‖² + ‖v‖² − 2 u·v`` — so the hot op is a
(q,n,d)×(q,d,n) batched matmul; XLA fuses the rank-1 corrections and the
exp.
"""
from __future__ import annotations

import jax.numpy as jnp


def rbf_gram(x1, x2, lengthscales, amplitudes, nuggets, *, same: bool,
             want_c0: bool = False):
    """Batched (q, n1, n2) SE Gram stack.

    C0 = exp(-0.5 * sum_j ((x1_j - x2_j)/l_j)^2), per-component l (q,d).
    ``want_c0`` also returns C0 for reuse by :func:`rbf_gram_vjp`.
    """
    x1 = jnp.asarray(x1)
    x2 = jnp.asarray(x2)
    lengthscales = jnp.atleast_2d(jnp.asarray(lengthscales))
    amplitudes = jnp.atleast_1d(jnp.asarray(amplitudes))
    nuggets = jnp.atleast_1d(jnp.asarray(nuggets))
    dt = x1.dtype

    inv_l = 1.0 / lengthscales                      # (q, d)
    u1 = x1[None, :, :] * inv_l[:, None, :]         # (q, n1, d)
    u2 = x2[None, :, :] * inv_l[:, None, :]         # (q, n2, d)

    # squared distances via one batched matmul: |u|^2 + |v|^2 - 2 u v^T
    sq1 = jnp.sum(u1 * u1, axis=-1)                 # (q, n1)
    sq2 = jnp.sum(u2 * u2, axis=-1)                 # (q, n2)
    cross = jnp.einsum('qnd,qmd->qnm', u1, u2)      # (q, n1, n2)
    d2 = sq1[:, :, None] + sq2[:, None, :] - 2.0 * cross
    d2 = jnp.maximum(d2, 0.0)                       # clamp fp cancellation
    c0 = jnp.exp(-0.5 * d2)

    eta = nuggets / (1.0 + nuggets)
    c = (1.0 - eta)[:, None, None] * c0
    if same:
        n1 = x1.shape[0]
        c = c + eta[:, None, None] * jnp.eye(n1, dtype=dt)[None, :, :]
    c = amplitudes[:, None, None] * c
    return (c, c0) if want_c0 else c


def rbf_gram_vjp(x1, x2, lengthscales, amplitudes, nuggets, *, same: bool,
                 cbar, c0=None):
    """Analytic VJP of :func:`rbf_gram` (see matern.matern32_gram_vjp).

    dC0/dl_j = C0 * s2_j / l_j with s2_j = ((x1_j - x2_j)/l_j)^2.
    """
    x1 = jnp.asarray(x1)
    x2 = jnp.asarray(x2)
    lengthscales = jnp.atleast_2d(jnp.asarray(lengthscales))
    amplitudes = jnp.atleast_1d(jnp.asarray(amplitudes))
    nuggets = jnp.atleast_1d(jnp.asarray(nuggets))
    d = x1.shape[1]
    dt = cbar.dtype

    inv_l = (1.0 / lengthscales).astype(dt)
    u1 = x1.astype(dt)[None, :, :] * inv_l[:, None, :]
    u2 = x2.astype(dt)[None, :, :] * inv_l[:, None, :]
    if c0 is None:
        sq1 = jnp.sum(u1 * u1, axis=-1)
        sq2 = jnp.sum(u2 * u2, axis=-1)
        d2 = jnp.maximum(sq1[:, :, None] + sq2[:, None, :]
                         - 2.0 * jnp.einsum('qnd,qmd->qnm', u1, u2), 0.0)
        c0 = jnp.exp(-0.5 * d2)
    else:
        c0 = c0.astype(dt)

    amp = amplitudes.astype(dt)
    nug = nuggets.astype(dt)
    eta = nug / (1.0 + nug)

    gc0 = jnp.sum(cbar * c0, axis=(-2, -1))
    if same:
        diag_cbar = jnp.trace(cbar, axis1=-2, axis2=-1)
        gamp = (1.0 - eta) * gc0 + eta * diag_cbar
        geta = amp * (diag_cbar - gc0)
    else:
        gamp = (1.0 - eta) * gc0
        geta = amp * (-gc0)
    gnug = geta / jnp.square(1.0 + nug)

    w = cbar * (amp * (1.0 - eta))[:, None, None] * c0
    glens = []
    for j in range(d):
        s2 = jnp.square(u1[:, :, j][:, :, None] - u2[:, :, j][:, None, :])
        glens.append(jnp.sum(w * s2, axis=(-2, -1)) * inv_l[:, j])
    glens = jnp.stack(glens, axis=-1)
    return (glens.astype(lengthscales.dtype),
            gamp.astype(amplitudes.dtype), gnug.astype(nuggets.dtype))
