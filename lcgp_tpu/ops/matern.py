"""Matérn 3/2 separable product kernel, batched over latent components.

Behavioral contract comes from the reference ``Matern32`` (reference
covmat.py:5-55), including its quirks (SURVEY.md §3.5.9):

- per-dimension lengthscales ``llmb`` divide the inputs directly (despite the
  ``l``-prefix these are *constrained positive values*, not logs);
- ``C0 = prod_j (1 + S_j) * exp(-sum_j S_j)`` with ``S_j = |u_j - v_j|``;
- nugget ``eta = lnug / (1 + lnug)``; the full matrix is
  ``llmb0 * ((1-eta) C0 + eta I)`` when x1 and x2 are *identical*, and
  ``llmb0 * (1-eta) C0`` (no diagonal) for cross-covariances;
- ``diag_only=True`` returns ``llmb0 * ones`` (amplitude only, no nugget),
  and requires x1 ≈ x2.

The design batches the q independent components as a leading axis (one
(q,n1,n2) Gram stack per call) instead of the reference's per-k Python
loop — this is what lets every downstream factorization run as batched XLA
linalg.
"""
from __future__ import annotations

import numpy as np

import jax.numpy as jnp


def matern32_gram(x1, x2, lengthscales, amplitudes, nuggets, *, same: bool,
                  want_c0: bool = False):
    """Batched Gram stack.

    Parameters
    ----------
    x1 : (n1, d) inputs.
    x2 : (n2, d) inputs.
    lengthscales : (q, d) per-component, per-dimension lengthscales.
    amplitudes : (q,) per-component amplitude (the reference's ``llmb0``).
    nuggets : (q,) per-component raw nugget parameter (the reference's
        ``lnug``); the effective nugget is ``lnug / (1 + lnug)``.
    same : static bool — True iff x1 and x2 are the *same* points, which
        switches on the nugget diagonal (reference covmat.py:46-53).  This is
        a static argument because the reference decides it with a
        data-dependent ``tf.reduce_all(tf.equal(...))`` which cannot exist
        under jit; all internal call sites know it statically.
    want_c0 : also return the raw correlation stack ``C0`` (before the
        nugget/amplitude epilogue) so callers can feed it back to
        :func:`matern32_gram_vjp` and skip its rebuild — the C0 build is
        the expensive part (d elementwise passes + one exp).

    Returns
    -------
    (q, n1, n2) covariance stack; ``(stack, c0)`` when ``want_c0``.
    """
    x1 = jnp.asarray(x1)
    x2 = jnp.asarray(x2)
    lengthscales = jnp.atleast_2d(jnp.asarray(lengthscales))
    amplitudes = jnp.atleast_1d(jnp.asarray(amplitudes))
    nuggets = jnp.atleast_1d(jnp.asarray(nuggets))

    d = x1.shape[1]
    inv_l = 1.0 / lengthscales  # (q, d)
    u1 = x1[None, :, :] * inv_l[:, None, :]  # (q, n1, d)
    u2 = x2[None, :, :] * inv_l[:, None, :]  # (q, n2, d)

    q, n1 = u1.shape[0], u1.shape[1]
    n2 = u2.shape[1]
    dt = u1.dtype
    prod = jnp.ones((q, n1, n2), dtype=dt)
    ssum = jnp.zeros((q, n1, n2), dtype=dt)
    # d is static and small (1..tens); an unrolled loop lets XLA fuse each
    # outer-difference into the accumulators without materializing (n1,n2,d).
    for j in range(d):
        s = jnp.abs(u1[:, :, j][:, :, None] - u2[:, :, j][:, None, :])
        prod = prod * (1.0 + s)
        ssum = ssum + s
    c0 = prod * jnp.exp(-ssum)

    eta = nuggets / (1.0 + nuggets)  # (q,)
    c = (1.0 - eta)[:, None, None] * c0
    if same:
        c = c + eta[:, None, None] * jnp.eye(n1, dtype=dt)[None, :, :]
    c = amplitudes[:, None, None] * c
    return (c, c0) if want_c0 else c


def matern32_gram_vjp(x1, x2, lengthscales, amplitudes, nuggets, *,
                      same: bool, cbar, c0=None):
    """Analytic, memory-light VJP of :func:`matern32_gram`.

    Given the cotangent ``cbar`` (q,n1,n2) of the Gram stack, returns
    (glens (q,d), gamp (q,), gnug (q,)) using one (q,n1,n2) temporary per
    d-step instead of autodiff's per-step residual chain:

        dC/dl_j   = amp (1-eta) C0 S_j^2 / ((1+S_j) l_j)
        dC/damp   = (1-eta) C0 + eta I[same]
        dC/dnug   = amp (I[same] - C0) / (1+nug)^2

    ``c0``: the forward's raw correlation stack (``want_c0=True``).  When
    given, the d-pass product/exp rebuild is skipped (only the per-dim
    |u-v| strips for glens are re-formed — abs-diffs, no transcendentals).
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
            prod = prod * (1.0 + s)
            ssum = ssum + s
        c0 = prod * jnp.exp(-ssum)
    else:
        c0 = c0.astype(dt)

    amp = amplitudes.astype(dt)
    nug = nuggets.astype(dt)
    eta = nug / (1.0 + nug)

    gc0 = jnp.sum(cbar * c0, axis=(-2, -1))                    # (q,)
    if same:
        diag_cbar = jnp.trace(cbar, axis1=-2, axis2=-1)        # sum of diag
        # diagonal of C0 is exactly 1 (S=0 there)
        gamp = (1.0 - eta) * gc0 + eta * diag_cbar
        geta = amp * (diag_cbar - gc0)
    else:
        gamp = (1.0 - eta) * gc0
        geta = amp * (-gc0)
    gnug = geta / jnp.square(1.0 + nug)

    w = cbar * (amp * (1.0 - eta))[:, None, None] * c0
    glens = []
    for j in range(d):
        s = jnp.abs(u1[:, :, j][:, :, None] - u2[:, :, j][:, None, :])
        glens.append(jnp.sum(w * s * s / (1.0 + s), axis=(-2, -1))
                     * inv_l[:, j])
    glens = jnp.stack(glens, axis=-1)                          # (q, d)
    return (glens.astype(lengthscales.dtype),
            gamp.astype(amplitudes.dtype), gnug.astype(nuggets.dtype))


def matern32_diag(x0, amplitudes, n_components: int | None = None):
    """Batched prior variance at x0: ``amp * 1`` per point (covmat.py:23-29).

    Returns (q, n0).
    """
    amplitudes = jnp.atleast_1d(jnp.asarray(amplitudes))
    n0 = jnp.asarray(x0).shape[0]
    return amplitudes[:, None] * jnp.ones((amplitudes.shape[0], n0), dtype=amplitudes.dtype)


def Matern32(x1, x2, llmb, llmb0, lnug, diag_only: bool = False,
             same: bool | None = None):
    """Single-component kernel with the reference's exact public signature
    and validation behavior (reference covmat.py:5-55).

    Accepts concrete (non-traced) arrays; the nugget-on-diagonal decision
    follows the reference's runtime rules: shapes must match *and* all values
    be equal.  Inside jit, use :func:`matern32_gram` with a static ``same``.

    ``same`` overrides the runtime x1==x2 check: pass ``True``/``False`` to
    skip it entirely.  With ``same=None`` the check short-circuits on object
    identity (``Matern32(x, x, ...)`` costs no host sync) and only falls back
    to a full ``np.array_equal`` — an O(n*d) device-to-host copy — for
    distinct same-shape arrays.
    """
    if same is None and x1 is x2:
        same = True
    x1 = jnp.asarray(x1)
    x2 = jnp.asarray(x2)
    assert x1.ndim == 2, 'input x1 should be 2-dimensional, (n_param, dim_param)'
    assert x2.ndim == 2, 'input x2 should be 2-dimensional, (n_param, dim_param)'
    assert x1.shape[1] == x2.shape[1], \
        'the dim_param of input x1 and x2 should be the same.'

    llmb = jnp.asarray(llmb, dtype=x1.dtype)
    llmb0 = jnp.asarray(llmb0, dtype=x1.dtype)
    lnug = jnp.asarray(lnug, dtype=x1.dtype)
    if llmb.ndim == 0:
        llmb = llmb[None]

    if diag_only:
        # same tolerance rule as the reference's assert (covmat.py:25)
        assert bool(np.all(np.abs(np.asarray(x1 - x2))
                           <= 1e-6 + 1e-6 * np.abs(np.asarray(x2)))), \
            'diag_only should only be called when x1 and x2 are identical.'
        return matern32_diag(x1, llmb0)[0]

    if same is None:
        if x1 is x2:
            same = True
        elif x1.shape != x2.shape:
            same = False
        else:
            same = bool(np.array_equal(np.asarray(x1), np.asarray(x2)))
    return matern32_gram(x1, x2, llmb[None, :], llmb0[None], lnug[None],
                         same=same)[0]
