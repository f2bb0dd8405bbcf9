"""Batched Cholesky primitives shared by the likelihood and predict paths.

All functions operate on a leading component/batch axis so XLA runs them as
batched linalg — this replaces both the reference's per-k Python loops
(reference lcgp.py:605, 650) and its joblib thread fan-out
(lcgp.py:718-720, 792-794).

The blocked factorization, the blocked triangular inverse and the strip-
structured products below, their block sizes and the f64-only routing of
``cholesky`` were chosen by timings on earlier hardware; none is measured
on the H100 yet (ROADMAP Q1.3).  They are correct on any backend.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax


def add_diag(mats, vals):
    """mats: (..., n, n); vals: scalar, (n,), or broadcastable (..., n)."""
    n = mats.shape[-1]
    eye = jnp.eye(n, dtype=mats.dtype)
    vals = jnp.asarray(vals, dtype=mats.dtype)
    if vals.ndim == 0:
        return mats + vals * eye
    return mats + vals[..., :, None] * eye


def cholesky(mats):
    """Batched lower Cholesky.

    f64 routes through :func:`cholesky_blocked`, f32 through XLA's native
    factorization — a split chosen on earlier hardware, not measured on the H100
    (ROADMAP Q1.3)."""
    if mats.dtype == jnp.float64:
        return cholesky_blocked(mats)
    return jnp.linalg.cholesky(mats)


_CHOL_BLOCK = 512


def cholesky_blocked(A, block: int | None = None):
    """Batched lower Cholesky via right-looking block factorization.

    Does the O(n^3) work as batched GEMMs instead of XLA's fine-grained
    panel loop:

      for each nb-block:  Lkk   = chol(trail[:nb, :nb])   (small, batched)
                          panel = trail[nb:, :nb] Lkk^{-T} (one GEMM)
                          trail = trail[nb:, nb:] - panel panel^T (one GEMM)

    The trailing update is one square GEMM per block step on a functionally
    SHRINKING trailing matrix, and the factor is assembled by concatenation.
    This costs 2n^3/3 GEMM flops — 2x the strip-triangular-update Cholesky
    count — because in-place formulations (`.at[].set` panel updates on the
    full (q,n,n) buffer) made XLA materialize whole-buffer copies per step.
    The form and ``_CHOL_BLOCK`` were chosen on earlier hardware, not measured
    on the H100 (ROADMAP Q1.3).

    Values agree with ``jnp.linalg.cholesky`` to the factorization's
    backward error (same algorithm at block granularity).  Non-block-
    divisible n pads with an identity tail (chol([[A,0],[0,I]]) =
    [[L,0],[0,I]]); n < 2 blocks falls back to XLA's native Cholesky.
    """
    n = A.shape[-1]
    nb = block or _CHOL_BLOCK
    if n < 2 * nb:
        return jnp.linalg.cholesky(A)
    if n % nb:
        np_ = _next_mult(n, nb)
        tail = jnp.concatenate([jnp.zeros((n,), dtype=A.dtype),
                                jnp.ones((np_ - n,), dtype=A.dtype)])
        Ap = _pad_nn(A, np_) + tail * jnp.eye(np_, dtype=A.dtype)
        return cholesky_blocked(Ap, block=nb)[..., :n, :n]
    L, _ = _cholesky_blocked_impl(A, nb, want_invs=False)
    return L


def _cholesky_blocked_impl(A, nb, want_invs):
    """Shared blocked-factorization loop.

    Returns (L, invs) where invs is the list of per-step diagonal-block
    triangular inverses (computed anyway for the panel GEMMs) when
    ``want_invs`` — the fused factor+inverse path reuses them — else None.
    """
    n = A.shape[-1]
    batch = A.shape[:-2]
    eye = jnp.broadcast_to(jnp.eye(nb, dtype=A.dtype), batch + (nb, nb))
    cols = []
    invs = [] if want_invs else None
    trail = A
    for k in range(0, n, nb):
        Lkk = jnp.linalg.cholesky(trail[..., :nb, :nb])
        above = jnp.zeros(batch + (k, nb), dtype=A.dtype)
        if k + nb == n:
            if want_invs:
                invs.append(solve_tri_lower(Lkk, eye))
            cols.append(jnp.concatenate([above, Lkk], axis=-2))
            break
        Lkk_inv = solve_tri_lower(Lkk, eye)
        if want_invs:
            invs.append(Lkk_inv)
        panel = jnp.matmul(trail[..., nb:, :nb],
                           jnp.swapaxes(Lkk_inv, -1, -2))
        cols.append(jnp.concatenate([above, Lkk, panel], axis=-2))
        trail = trail[..., nb:, nb:] - jnp.matmul(
            panel, jnp.swapaxes(panel, -1, -2))
    return jnp.concatenate(cols, axis=-1), invs


def cholesky_tri_inverse(A, block: int | None = None):
    """Fused batched (L, L^{-1}) for SPD A.

    The blocked f64 Cholesky already inverts every diagonal block for its
    panel GEMMs; ``tri_inverse_lower`` run separately would re-invert the
    same blocks (8 batched triangular solves at the headline config).
    This fusion factors once, keeps those inverses, and runs only the
    off-diagonal combination GEMMs of the blocked triangular inversion.
    Non-f64 dtypes and small n fall back to the unfused pair (see
    :func:`cholesky`).  Chosen on earlier hardware; not measured on the H100
    (ROADMAP Q1.3)."""
    n = A.shape[-1]
    nb = block or _CHOL_BLOCK
    if A.dtype != jnp.float64 or n < 2 * nb:
        L = cholesky(A)
        return L, tri_inverse_lower(L)
    if n % nb:
        np_ = _next_mult(n, nb)
        tail = jnp.concatenate([jnp.zeros((n,), dtype=A.dtype),
                                jnp.ones((np_ - n,), dtype=A.dtype)])
        Ap = _pad_nn(A, np_) + tail * jnp.eye(np_, dtype=A.dtype)
        L, X = cholesky_tri_inverse(Ap, block=nb)
        return L[..., :n, :n], X[..., :n, :n]
    L, invs = _cholesky_blocked_impl(A, nb, want_invs=True)
    return L, _tri_inverse_combine(L, invs, nb)


def chol_logdet(chols):
    """logdet(A) from L with A = L L^T; batched over leading axes.

    The n-length sum accumulates in f64 even for f32 factors — at large n
    an f32 accumulation resolves the result only to ~sqrt(n)*eps32*|sum|,
    which starves optimizers of loss signal."""
    diag = jnp.diagonal(chols, axis1=-2, axis2=-1)
    return 2.0 * jnp.sum(jnp.log(diag).astype(jnp.float64), axis=-1)


def solve_tri_lower(chols, rhs):
    """L^{-1} rhs with lower-triangular L; rhs (..., n, m)."""
    return lax.linalg.triangular_solve(
        chols, rhs, left_side=True, lower=True, transpose_a=False)


def cho_solve(chols, rhs):
    """(L L^T)^{-1} rhs; rhs (..., n, m)."""
    z = lax.linalg.triangular_solve(
        chols, rhs, left_side=True, lower=True, transpose_a=False)
    return lax.linalg.triangular_solve(
        chols, z, left_side=True, lower=True, transpose_a=True)


def cho_solve_vec(chols, vecs):
    """(L L^T)^{-1} v with v (..., n)."""
    return cho_solve(chols, vecs[..., :, None])[..., :, 0]


_TRI_INV_BLOCK = 512

# Precision for the f32 inverse-combination GEMMs of the gradient path.
# On an H100, XLA runs an f32 matmul at Precision.HIGH in TF32 (relative
# error 2.9e-4 on a 4096^2 product, the same as DEFAULT; HIGHEST: 1.1e-6).
# At the headline config HIGH raised the 'fast' gradient's error against
# f64 from 1.5e-6 to 2.5e-5 — 16x what true-f32 GEMMs hold — for a
# warm loss+grad of 0.069 s instead of 0.092 s (one call each, H100 at
# 700 W).  HIGHEST keeps them true f32; chip_smoke.py's 'fast' gradient
# tolerance (1e-5) holds the path to it.  f64 inputs ignore the setting.
_INV_GEMM_PRECISION = lax.Precision.HIGHEST


def _inv_mm(a, b):
    return jnp.matmul(a, b, precision=_INV_GEMM_PRECISION)


def tri_inverse_lower(chols):
    """L^{-1} for lower-triangular L, batched.

    Blocked: invert the diagonal blocks, combine the off-diagonal blocks
    with GEMMs, instead of one triangular_solve against the identity.
    Values agree to the roundoff of the accumulation order.  The blocked
    form and ``_TRI_INV_BLOCK`` were chosen on earlier hardware, not measured
    on the H100 (ROADMAP Q1.3).
    """
    n = chols.shape[-1]
    nb = _TRI_INV_BLOCK
    if n % nb or n // nb < 2:
        eye = jnp.broadcast_to(jnp.eye(n, dtype=chols.dtype), chols.shape)
        return solve_tri_lower(chols, eye)
    nd = n // nb
    batch = chols.shape[:-2]
    eye = jnp.broadcast_to(jnp.eye(nb, dtype=chols.dtype),
                           batch + (nb, nb))
    invs = [solve_tri_lower(chols[..., k * nb:(k + 1) * nb,
                                  k * nb:(k + 1) * nb], eye)
            for k in range(nd)]
    return _tri_inverse_combine(chols, invs, nb)


def _tri_inverse_combine(chols, invs, nb):
    """Off-diagonal combination of the blocked triangular inversion, given
    the per-block diagonal inverses (shared with the fused
    :func:`cholesky_tri_inverse`)."""
    nd = chols.shape[-1] // nb
    X = jnp.zeros_like(chols)
    for k in range(nd):
        ck = slice(k * nb, (k + 1) * nb)
        X = X.at[..., ck, ck].set(invs[k])
        for i in range(k + 1, nd):
            ci = slice(i * nb, (i + 1) * nb)
            mid = slice(k * nb, i * nb)
            acc = _inv_mm(chols[..., ci, mid], X[..., mid, ck])
            X = X.at[..., ci, ck].set(-_inv_mm(invs[i], acc))
    return X


_TRI_SYRK_BLOCK = 512


def _pad_nn(A, np_):
    """Zero-pad the trailing (n, n) dims to (np_, np_).

    Every structured product below is zero-padding-equivariant: padding a
    lower-triangular operand with zero rows/columns leaves the top-left
    n x n block of the product equal to the unpadded product (the padded
    rows/columns contribute only zeros to every contraction).  This is how
    non-block-divisible n gets the structured flop saving: pad to the next
    multiple of the block, run the blocked path, slice back — an O(n^2)
    copy against the O(n^3) GEMMs it unlocks.
    """
    n = A.shape[-1]
    return jnp.pad(A, [(0, 0)] * (A.ndim - 2)
                   + [(0, np_ - A.shape[-2]), (0, np_ - n)])


def _next_mult(n, nb):
    return -(-n // nb) * nb


def _sym_from_block_lower(S, nd, nb):
    """Full symmetric matrix from its block-lower representation S.

    S holds the block-lower triangle (diagonal blocks included, themselves
    symmetric); everything block-above is zero.  A = S + S^T counts the
    diagonal blocks twice, so one copy is subtracted back per block — nd
    (nb, nb) dynamic-update-slices, trivial next to the strip GEMMs.
    """
    A = S + jnp.swapaxes(S, -1, -2)
    for j in range(nd):
        cj = slice(j * nb, (j + 1) * nb)
        A = A.at[..., cj, cj].add(-S[..., cj, cj])
    return A


def syrk_tri_lower(L, precision=None):
    """L @ L^T for LOWER-TRIANGULAR L via column-strip GEMMs.

    A dense matmul spends 2n^3 flops; L's triangularity cuts the true cost
    to n^3/3 — 6x fewer.  XLA never exploits operand structure, so the
    blocking is done here: block-column j of the result's lower triangle is
    one GEMM ``L[jb:, :w] @ L[jb:jb+nb, :w]^T`` with contraction width
    w = (j+1)*nb (columns of L beyond w are zero in both operands), and the
    symmetric full matrix is assembled from the strips.  The
    mixed-precision refinement residual (ops/mixed.cholesky_mixed) is
    exactly this product.  Non-block-divisible n is zero-padded to the
    next block multiple (see ``_pad_nn``); only n < 2 blocks falls back to
    the dense matmul (small-n parity configs, where the strips would
    degenerate to one dense GEMM anyway).
    """
    n = L.shape[-1]
    nb = _TRI_SYRK_BLOCK
    if n < 2 * nb:
        return jnp.matmul(L, jnp.swapaxes(L, -1, -2), precision=precision)
    if n % nb:
        np_ = _next_mult(n, nb)
        return syrk_tri_lower(_pad_nn(L, np_), precision)[..., :n, :n]
    # block-column strips are exactly mul_t_block_lower's with Y = M = L;
    # the symmetric full matrix is assembled from them.
    S = mul_t_block_lower(L, L, precision=precision)
    return _sym_from_block_lower(S, n // nb, nb)


def gram_tri_lower(M, precision=None):
    """M^T @ M for LOWER-TRIANGULAR M via row-strip GEMMs (n^3/3 flops).

    Same structure argument as ``syrk_tri_lower``: block (i, j) of the
    Gram (j <= i) only contracts over rows >= i*nb, so block-row i of the
    lower triangle is one GEMM ``M[ib:, ib:ib+nb]^T @ M[ib:, :w]``.  This
    is the potri combination step — (L^{-1})^T L^{-1} — the dominant GEMM
    of every loss backward (f64, f32, and the mixed f32 potri seed).
    Non-block-divisible n is zero-padded (``_pad_nn``); n < 2 blocks falls
    back to the dense matmul.
    """
    n = M.shape[-1]
    nb = _TRI_SYRK_BLOCK
    if n < 2 * nb:
        return jnp.matmul(jnp.swapaxes(M, -1, -2), M, precision=precision)
    if n % nb:
        np_ = _next_mult(n, nb)
        return gram_tri_lower(_pad_nn(M, np_), precision)[..., :n, :n]
    nd = n // nb
    S = jnp.zeros_like(M)
    for i in range(nd):
        w = (i + 1) * nb
        strip = jnp.matmul(
            jnp.swapaxes(M[..., i * nb:, i * nb:(i + 1) * nb], -1, -2),
            M[..., i * nb:, :w], precision=precision)
        S = S.at[..., i * nb:(i + 1) * nb, :w].set(strip)
    return _sym_from_block_lower(S, nd, nb)


def trmm_lower(L, X, precision=None):
    """L @ X with LOWER-TRIANGULAR L and dense X: n^3 flops vs dense 2n^3.

    Block-row i of the product only contracts over columns < (i+1)*nb of L
    (zero beyond), so it is one GEMM ``L[ib:ib+nb, :w] @ X[:w, :]``.
    Non-block-divisible n is zero-padded (``_pad_nn``; X gets zero rows);
    n < 2 blocks falls back to the dense matmul.
    """
    n = L.shape[-1]
    nb = _TRI_SYRK_BLOCK
    if n < 2 * nb:
        return jnp.matmul(L, X, precision=precision)
    if n % nb:
        np_ = _next_mult(n, nb)
        Xp = jnp.pad(X, [(0, 0)] * (X.ndim - 2) + [(0, np_ - n), (0, 0)])
        return trmm_lower(_pad_nn(L, np_), Xp, precision)[..., :n, :]
    nd = n // nb
    rows = []
    for i in range(nd):
        w = (i + 1) * nb
        rows.append(jnp.matmul(L[..., i * nb:(i + 1) * nb, :w],
                               X[..., :w, :], precision=precision))
    return jnp.concatenate(rows, axis=-2)


def mul_t_block_lower(Y, M, precision=None):
    """Block-lower triangle of Y @ M^T with LOWER-TRIANGULAR M (n^3/3).

    Block (i, j), j <= i, contracts only over columns < (j+1)*nb (rows of
    M^T beyond are zero), so block-column j of the result's lower triangle
    is one GEMM ``Y[jb:, :w] @ M[jb:jb+nb, :w]^T``.

    CONTRACT: only entries on or below the diagonal are specified.  The
    blocked path leaves the strict block-upper region ZERO; the small-n
    dense fallback returns the full product (a superset).  Callers must
    consume at most ``tril`` of the result (the Cholesky-refinement
    projector does, via ``_phi_lower``'s tril).  Non-block-divisible n is
    zero-padded (``_pad_nn``); n < 2 blocks falls back to the dense
    matmul.
    """
    n = M.shape[-1]
    nb = _TRI_SYRK_BLOCK
    if n < 2 * nb:
        return jnp.matmul(Y, jnp.swapaxes(M, -1, -2), precision=precision)
    if n % nb:
        np_ = _next_mult(n, nb)
        return mul_t_block_lower(_pad_nn(Y, np_), _pad_nn(M, np_),
                                 precision)[..., :n, :n]
    nd = n // nb
    S = jnp.zeros_like(Y)
    for j in range(nd):
        w = (j + 1) * nb
        strip = jnp.matmul(
            Y[..., j * nb:, :w],
            jnp.swapaxes(M[..., j * nb:(j + 1) * nb, :w], -1, -2),
            precision=precision)
        S = S.at[..., j * nb:, j * nb:(j + 1) * nb].set(strip)
    return S


def mul_lower_lower(A, B, precision=None):
    """A @ B with BOTH operands lower triangular — the product is lower
    triangular.  Block-row i only contracts over k < (i+1)*nb and only
    its first (i+1)*nb columns are nonzero, so it is one GEMM
    ``A[ib:ib+nb, :w] @ B[:w, :w]`` plus zero-padding: 2n^3/3 flops
    (3x under the dense 2n^3; the per-block-pair n^3/3 form would need
    N^2/2 dispatches for one more 2x — not worth the launch overhead).
    Non-block-divisible n is zero-padded (``_pad_nn``); n < 2 blocks falls
    back to the dense matmul.
    """
    n = A.shape[-1]
    nb = _TRI_SYRK_BLOCK
    if n < 2 * nb:
        return jnp.matmul(A, B, precision=precision)
    if n % nb:
        np_ = _next_mult(n, nb)
        return mul_lower_lower(_pad_nn(A, np_), _pad_nn(B, np_),
                               precision)[..., :n, :n]
    nd = n // nb
    rows = []
    for i in range(nd):
        w = (i + 1) * nb
        # columns >= w of the result's row-block are zero (both lower
        # triangular); compute only the [:w] slab and pad.
        blk = jnp.matmul(A[..., i * nb:(i + 1) * nb, :w],
                         B[..., :w, :w], precision=precision)
        pad = jnp.zeros(blk.shape[:-1] + (n - w,), dtype=blk.dtype)
        rows.append(jnp.concatenate([blk, pad], axis=-1))
    return jnp.concatenate(rows, axis=-2)


def chol_inverse(chols):
    """(L L^T)^{-1} as Linv^T Linv with Linv = L^{-1} (LAPACK potri shape).

    One triangular inverse + one symmetric matmul instead of the two
    chained triangular solves of ``cho_solve(L, I)`` — a choice made on
    earlier hardware, not measured on the H100 (ROADMAP Q1.3).  The combination exploits
    Linv's triangularity (``gram_tri_lower``: n^3/3 flops instead of the
    dense 2n^3).
    """
    linv = tri_inverse_lower(chols)
    return gram_tri_lower(linv, precision=_INV_GEMM_PRECISION)


def quad_chol(chols, vecs):
    """v^T (L L^T)^{-1} v, batched; v (..., n)."""
    z = solve_tri_lower(chols, vecs[..., :, None])[..., :, 0]
    return jnp.sum(z * z, axis=-1)
