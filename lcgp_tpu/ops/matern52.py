"""Matérn 5/2 separable product kernel, batched over latent components.

An *extra* beyond the reference (which ships only Matérn 3/2,
covmat.py:5-55), following the same separable-product convention: the
kernel is the product of 1-D Matérn 5/2 factors,

    C0 = prod_j (1 + a s_j + (a^2/3) s_j^2) * exp(-a * sum_j s_j),
    s_j = |u_j - v_j|,  a = sqrt(5)

with the reference's nugget/amplitude semantics (SURVEY §3.5.9):
``eta = lnug/(1+lnug)``; ``amp * ((1-eta) C0 + eta I)`` when x1 ≡ x2,
``amp * (1-eta) C0`` for cross-covariances; prior variance is ``amp``.

Same structure as ops/matern.py: the static d-loop accumulates the
per-dimension polynomial product and the |u-v| sum so XLA fuses
everything into one elementwise pass over the (q, n1, n2) tile.
"""
from __future__ import annotations

import math

import jax.numpy as jnp

_A = math.sqrt(5.0)


def matern52_gram(x1, x2, lengthscales, amplitudes, nuggets, *, same: bool,
                  want_c0: bool = False):
    """Batched (q, n1, n2) Matérn 5/2 Gram stack.

    ``want_c0`` also returns the raw correlation stack for reuse by
    :func:`matern52_gram_vjp` (see ops/matern.py)."""
    x1 = jnp.asarray(x1)
    x2 = jnp.asarray(x2)
    lengthscales = jnp.atleast_2d(jnp.asarray(lengthscales))
    amplitudes = jnp.atleast_1d(jnp.asarray(amplitudes))
    nuggets = jnp.atleast_1d(jnp.asarray(nuggets))

    d = x1.shape[1]
    inv_l = 1.0 / lengthscales
    u1 = x1[None, :, :] * inv_l[:, None, :]
    u2 = x2[None, :, :] * inv_l[:, None, :]

    q, n1 = u1.shape[0], u1.shape[1]
    n2 = u2.shape[1]
    dt = u1.dtype
    prod = jnp.ones((q, n1, n2), dtype=dt)
    ssum = jnp.zeros((q, n1, n2), dtype=dt)
    for j in range(d):
        s = jnp.abs(u1[:, :, j][:, :, None] - u2[:, :, j][:, None, :])
        prod = prod * (1.0 + _A * s + (5.0 / 3.0) * s * s)
        ssum = ssum + s
    c0 = prod * jnp.exp(-_A * ssum)

    eta = nuggets / (1.0 + nuggets)
    c = (1.0 - eta)[:, None, None] * c0
    if same:
        c = c + eta[:, None, None] * jnp.eye(n1, dtype=dt)[None, :, :]
    c = amplitudes[:, None, None] * c
    return (c, c0) if want_c0 else c


def matern52_gram_vjp(x1, x2, lengthscales, amplitudes, nuggets, *,
                      same: bool, cbar, c0=None):
    """Analytic VJP (glens (q,d), gamp (q,), gnug (q,)).

    Per-dimension log-derivative of the 1-D factor
    f(s) = (1 + a s + (a^2/3) s^2) e^{-a s}:

        d ln f / d s = -(a^2/3) s (1 + a s) / (1 + a s + (a^2/3) s^2)

    and with s = |dx|/l, ds/dl = -s/l, so
        dC/dl_j = C * (a^2/3) s^2 (1 + a s) / ((1 + a s + (a^2/3) s^2) l_j).
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
        q, n1 = u1.shape[0], u1.shape[1]
        prod = jnp.ones((q, n1, u2.shape[1]), dtype=dt)
        ssum = jnp.zeros_like(prod)
        for j in range(d):
            s = jnp.abs(u1[:, :, j][:, :, None] - u2[:, :, j][:, None, :])
            prod = prod * (1.0 + _A * s + (5.0 / 3.0) * s * s)
            ssum = ssum + s
        c0 = prod * jnp.exp(-_A * ssum)
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
    five3 = 5.0 / 3.0
    glens = []
    for j in range(d):
        s = jnp.abs(u1[:, :, j][:, :, None] - u2[:, :, j][:, None, :])
        poly = 1.0 + _A * s + five3 * s * s
        glens.append(jnp.sum(w * five3 * s * s * (1.0 + _A * s) / poly,
                             axis=(-2, -1)) * inv_l[:, j])
    glens = jnp.stack(glens, axis=-1)
    return (glens.astype(lengthscales.dtype),
            gamp.astype(amplitudes.dtype), gnug.astype(nuggets.dtype))
