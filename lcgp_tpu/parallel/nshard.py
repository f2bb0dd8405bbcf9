"""n-axis sharded linear algebra for the large-n regime.

The ('comp','out') mesh (mesh.py) parallelizes the q component stack and
the p output axis — the wrong axes once a single replica's Gram matrix no
longer fits one chip.  This module shards the *design-point* axis n:

- each device owns a block of Gram rows: the local working set is
  (q, n/ndev, n), so total HBM for the stack scales down linearly with
  devices;
- a ScaLAPACK-style right-looking blocked Cholesky runs over the block
  rows inside ``shard_map``, with exactly two small collectives per panel
  step (a psum of the (q, nb, nb) diagonal block and an all_gather of the
  panel column) over the device interconnect;
- blocked forward/back substitution (single- and multi-RHS) and the
  logdet come from the same distributed factor;
- :func:`neglpost_full_nsharded` / :func:`neglpost_rep_nsharded` evaluate
  the training losses (reference lcgp.py:635-666 / 554-630 semantics,
  identical to ``likelihood.neglpost_*``) without any device ever
  materializing a whole (n, n) Gram — **including the backward**: both
  losses carry custom VJPs mirroring ``models/likelihood.py`` (closed-form
  gradient from the saved distributed factor + one solve vector), so the
  per-device backward working set is O(q · n/ndev · n) instead of
  autodiff-through-the-unrolled-factorization's ~ndev× that;
- :func:`compute_aux_nsharded` + :func:`predict_nsharded_core` are the
  n-sharded predictive path (the factor stays row-distributed; the
  (q, n, n0) cross-covariance solve is a distributed multi-RHS forward
  substitution), so a model whose training needed n-sharding can also
  predict.

The panel loop is a static Python loop of length ndev — under jit it
unrolls into a fixed program (no data-dependent control flow).

2-D ('comp','n') meshes (round 4): every entry point also accepts a mesh
with a leading 'comp' axis (:func:`make_nc_mesh`) that shards the q
component stack *across* device groups while each group runs the n-sharded
algorithm above on its components.  The sequential panel loop's length is
the **n-axis size only**, so at pod scale ('comp' × 'n') keeps the
factorization's critical path short (e.g. 256 chips as 32×8 → 8 panel
steps, not 256) while per-device memory still divides by the full device
count.  No cross-component collectives exist: the bodies are unchanged,
only the shard_map specs map the q axis onto 'comp'.  q not divisible by
the comp size is zero-padded with neutral components whose terms are
sliced away (gradients unpad automatically through ``jnp.pad``'s VJP).
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from ..models import params as Pm
from ..models.likelihood import FullData, RepData
from ..ops.gram import gram_stack, gram_vjp
from ..ops.matern import matern32_diag

AXIS = 'n'
COMP = 'comp'


def make_n_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    """1-D ('n',) mesh over the given (or all) devices."""
    devices = list(jax.devices()) if devices is None else list(devices)
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (AXIS,))


def make_nc_mesh(n_comp: int, n_n: int, devices=None) -> Mesh:
    """2-D ('comp','n') mesh: q components sharded over 'comp' groups,
    each group running the n-sharded algorithm over its 'n' submesh.

    'comp' is the outer axis, so each group's 'n' devices are consecutive
    in device order; the heavy collectives (panel all_gathers, row psums)
    stay inside a group while 'comp' needs no collectives at all."""
    devices = list(jax.devices()) if devices is None else list(devices)
    if len(devices) < n_comp * n_n:
        raise ValueError(f'need {n_comp * n_n} devices, have {len(devices)}')
    arr = np.array(devices[:n_comp * n_n]).reshape(n_comp, n_n)
    return Mesh(arr, (COMP, AXIS))


def is_n_mesh(mesh) -> bool:
    """True for meshes this module executes on: ('n',) or ('comp','n')."""
    return tuple(mesh.axis_names) in ((AXIS,), (COMP, AXIS))


def data_shardings(mesh: Mesh, data):
    """Sharding pytree matching a FullData/RepData for this mesh.

    n-axis leaves (xs rows, ys/ybar columns, r) shard over 'n' and
    replicate over 'comp'; everything else replicates.  Used as
    ``AuxLoss.aux_sharding`` so :func:`~lcgp_tpu.fit.auxloss.split_aux`
    stages each training leaf directly with its mesh layout instead of
    landing the whole pytree on one device (which at pod-scale n would
    OOM the staging chip)."""
    from jax.sharding import NamedSharding
    rep = NamedSharding(mesh, P())
    # device_put needs the sharded dim divisible by the axis size; when n
    # isn't (the losses pad internally), replicate — correctness is
    # unaffected, only the staging layout.
    if data.xs.shape[0] % _n_size(mesh):
        row = col = rep
    else:
        row = NamedSharding(mesh, P(AXIS))       # (n, ...) leaves
        col = NamedSharding(mesh, P(None, AXIS))  # (p, n) leaves
    if isinstance(data, RepData):
        return RepData(xs=row, ybar=col, scale=rep, r=row, phi=rep,
                       diag_D=rep, sigma_map=rep)
    return FullData(xs=row, ys=col, phi=rep, diag_D=rep, sigma_map=rep)


def _n_size(mesh: Mesh) -> int:
    """Devices along the n axis (the panel-loop length)."""
    return mesh.shape[AXIS]


def _qax(mesh: Mesh):
    """Mesh axis the q component dim maps to (None on a 1-D ('n',) mesh)."""
    return COMP if COMP in mesh.axis_names else None


def _q_pad(mesh: Mesh, q: int) -> int:
    """q padded up to a multiple of the comp-axis size."""
    nc = mesh.shape[COMP] if COMP in mesh.axis_names else 1
    return -(-q // nc) * nc


def _pad_q(a, qp: int, fill: float = 0.0):
    """Pad axis 0 (the q component axis) of ``a`` up to qp with ``fill``.

    Gradients unpad automatically: the loss only consumes the first q
    entries of the per-component terms, so padded components receive zero
    cotangents and ``jnp.pad``'s VJP slices the (zero) tail away."""
    if a.shape[0] == qp:
        return a
    widths = [(0, qp - a.shape[0])] + [(0, 0)] * (a.ndim - 1)
    return jnp.pad(a, widths, constant_values=fill)


def _pad_q_params(mesh, lLmb, lLmb0, lnug):
    """Pad the q axis of the kernel params by tiling the last component —
    benign values that keep every padded Gram factorization well-posed."""
    qp = _q_pad(mesh, lLmb0.shape[0])
    if qp == lLmb0.shape[0]:
        return lLmb, lLmb0, lnug
    reps = [(0, qp - lLmb.shape[0])] + [(0, 0)] * (lLmb.ndim - 1)
    return (jnp.pad(lLmb, reps, mode='edge'),
            jnp.pad(lLmb0, (0, qp - lLmb0.shape[0]), mode='edge'),
            jnp.pad(lnug, (0, qp - lnug.shape[0]), mode='edge'))


def _is_mine(idx, k):
    return jnp.where(idx == k, 1.0, 0.0)


# ---------------------------------------------------------------------------
# Distributed factorization / substitution primitives (shard_map bodies).
# Layout convention: (q, nb, n) = this device's block of rows of a (q, n, n)
# stack; (q, nb, m) = this device's block of rows of (q, n, m) right-hand
# sides.  nb * ndev == n always (callers pad).
# ---------------------------------------------------------------------------


def _dist_cholesky_local(Ablk, ndev: int):
    """Distributed lower-Cholesky of a PSD (q, n, n) stack, block-rows local.

    Ablk: this device's (q, nb, n) block of rows.  Returns the matching
    (q, nb, n) block of rows of L with A = L L^T.  Right-looking blocked
    algorithm; panel k's diagonal block is psum-broadcast, the factored
    panel column is all_gathered, and each device applies its own trailing
    GEMM update.
    """
    q, nb, n = Ablk.shape
    assert nb * ndev == n
    idx = lax.axis_index(AXIS)
    L = jnp.zeros_like(Ablk)
    for k in range(ndev):
        cols = slice(k * nb, (k + 1) * nb)
        # true (updated) diagonal block, identical on every device
        diag = lax.psum(_is_mine(idx, k) * Ablk[:, :, cols], AXIS)
        Lkk = jnp.linalg.cholesky(diag)                      # (q, nb, nb)
        # my panel block: L_ik = A_ik Lkk^{-T} (valid for idx > k)
        Lik = lax.linalg.triangular_solve(
            Lkk, Ablk[:, :, cols], left_side=False, lower=True,
            transpose_a=True)
        panel_blk = jnp.where(idx == k, Lkk,
                              jnp.where(idx > k, Lik, jnp.zeros_like(Lik)))
        L = L.at[:, :, cols].set(panel_blk)
        if k + 1 < ndev:
            panel = lax.all_gather(panel_blk, AXIS)          # (ndev, q, nb, nb)
            below = jnp.moveaxis(panel[k + 1:], 0, 1)        # (q, m, nb, nb)
            below = below.reshape(q, (ndev - 1 - k) * nb, nb)
            upd = jnp.einsum('qab,qcb->qac', panel_blk, below)
            Ablk = Ablk.at[:, :, (k + 1) * nb:].add(
                -jnp.where(idx > k, 1.0, 0.0) * upd)
    return L


def _dist_solve_rows_local(Lblk, Bblk, ndev: int, transpose: bool = False):
    """Triangular solve with the distributed factor, multi-RHS.

    L Y = B (transpose=False) or L^T Y = B (transpose=True), where B's
    block-rows are distributed: Bblk (q, nb, m) is my rows.  Returns my
    rows of Y.  Block forward (resp. backward) substitution; per step one
    psum broadcasts the owner's diagonal/rhs blocks.
    """
    q, nb, n = Lblk.shape
    idx = lax.axis_index(AXIS)
    if not transpose:
        y = jnp.zeros_like(Bblk)
        acc = jnp.zeros_like(Bblk)
        for k in range(ndev):
            cols = slice(k * nb, (k + 1) * nb)
            diag = lax.psum(_is_mine(idx, k) * Lblk[:, :, cols], AXIS)
            rhs = lax.psum(_is_mine(idx, k) * (Bblk - acc), AXIS)
            yk = lax.linalg.triangular_solve(
                diag, rhs, left_side=True, lower=True)
            y = jnp.where(idx == k, yk, y)
            if k + 1 < ndev:
                acc = acc + jnp.where(idx > k, 1.0, 0.0) * \
                    jnp.einsum('qab,qbm->qam', Lblk[:, :, cols], yk)
        return y
    x = jnp.zeros_like(Bblk)
    for k in reversed(range(ndev)):
        cols = slice(k * nb, (k + 1) * nb)
        # sum_{j>k} L_jk^T x_j: device j holds L's block (j, k) in its rows
        contrib = jnp.where(idx > k, 1.0, 0.0) * \
            jnp.einsum('qab,qam->qbm', Lblk[:, :, cols], x)
        s = lax.psum(contrib, AXIS)
        diag = lax.psum(_is_mine(idx, k) * Lblk[:, :, cols], AXIS)
        rhs = lax.psum(_is_mine(idx, k) * Bblk, AXIS) - s
        xk = lax.linalg.triangular_solve(
            diag, rhs, left_side=True, lower=True, transpose_a=True)
        x = jnp.where(idx == k, xk, x)
    return x


def _dist_cho_solve_rows_local(Lblk, Bblk, ndev: int):
    """(L L^T)^{-1} B with B's block-rows distributed; (q, nb, m) local."""
    y = _dist_solve_rows_local(Lblk, Bblk, ndev, transpose=False)
    return _dist_solve_rows_local(Lblk, y, ndev, transpose=True)


def _dist_cho_solve_vec_local(Lblk, bblk, ndev: int):
    """Solve (L L^T) x = b with the distributed factor; b block-local (q, nb)."""
    return _dist_cho_solve_rows_local(Lblk, bblk[..., None], ndev)[..., 0]


def _eye_rows(idx, nb: int, n: int, dtype):
    """My (nb, n) block of rows of the n×n identity."""
    rows_global = idx * nb + jnp.arange(nb)
    return (jnp.arange(n)[None, :] == rows_global[:, None]).astype(dtype)


def _dist_chol_inverse_rows_local(Lblk, ndev: int):
    """My (q, nb, n) rows of (L L^T)^{-1} from the distributed factor.

    One distributed multi-RHS cho_solve against the identity whose rows are
    naturally distributed; by symmetry of the inverse, the result rows are
    exact.  Per-device transient: O(q · nb · n), same as the factor block.
    """
    q, nb, n = Lblk.shape
    idx = lax.axis_index(AXIS)
    eye_blk = jnp.broadcast_to(_eye_rows(idx, nb, n, Lblk.dtype)[None],
                               (q, nb, n))
    return _dist_cho_solve_rows_local(Lblk, eye_blk, ndev)


def _dist_chol_logdet_local(Lblk, ndev: int):
    """logdet(A) = 2 sum log diag(L); diag entries live on the owner rows."""
    q, nb, n = Lblk.shape
    idx = lax.axis_index(AXIS)
    zero = jnp.zeros((), dtype=idx.dtype)
    mine = lax.dynamic_slice(Lblk, (zero, zero, idx * nb), (q, nb, nb))
    d = jnp.diagonal(mine, axis1=-2, axis2=-1)
    # n-length log-sum accumulates in f64 even for f32 factors, matching
    # linalg.chol_logdet (f32 sums starve the optimizer of loss signal)
    return lax.psum(2.0 * jnp.sum(jnp.log(d).astype(jnp.float64), axis=-1),
                    AXIS)


def _gather_vec(blk, n: int):
    """all_gather a (q, nb)-sharded row vector to the full (q, n)."""
    g = lax.all_gather(blk, AXIS)                    # (ndev, q, nb)
    return jnp.moveaxis(g, 0, 1).reshape(blk.shape[0], n)


def dist_cholesky(mesh: Mesh, A):
    """Distributed Cholesky of a replicated-or-sharded (q, n, n) PSD stack.

    Returns L with the row axis sharded over 'n'.  n must divide evenly by
    the mesh size (use the loss wrapper for automatic padding).
    """
    ndev = _n_size(mesh)
    fn = jax.shard_map(
        partial(_dist_cholesky_local, ndev=ndev), mesh=mesh,
        in_specs=P(None, AXIS, None), out_specs=P(None, AXIS, None))
    return fn(A)


def dist_cho_solve_vec(mesh: Mesh, L, b):
    """Distributed (L L^T)^{-1} b for the factor from :func:`dist_cholesky`."""
    ndev = _n_size(mesh)
    fn = jax.shard_map(
        partial(_dist_cho_solve_vec_local, ndev=ndev), mesh=mesh,
        in_specs=(P(None, AXIS, None), P(None, AXIS)),
        out_specs=P(None, AXIS))
    return fn(L, b)


def dist_cho_solve(mesh: Mesh, L, B):
    """Distributed (L L^T)^{-1} B, B (q, n, m) with rows sharded."""
    ndev = _n_size(mesh)
    fn = jax.shard_map(
        partial(_dist_cho_solve_rows_local, ndev=ndev), mesh=mesh,
        in_specs=(P(None, AXIS, None), P(None, AXIS, None)),
        out_specs=P(None, AXIS, None))
    return fn(L, B)


def dist_chol_inverse(mesh: Mesh, L):
    """Distributed (L L^T)^{-1}, returned row-sharded."""
    ndev = _n_size(mesh)
    fn = jax.shard_map(
        partial(_dist_chol_inverse_rows_local, ndev=ndev), mesh=mesh,
        in_specs=P(None, AXIS, None), out_specs=P(None, AXIS, None))
    return fn(L)


def dist_chol_logdet(mesh: Mesh, L):
    ndev = _n_size(mesh)
    fn = jax.shard_map(
        partial(_dist_chol_logdet_local, ndev=ndev), mesh=mesh,
        in_specs=P(None, AXIS, None), out_specs=P(None))
    return fn(L)


# ---------------------------------------------------------------------------
# Shared local helpers for the losses / aux
# ---------------------------------------------------------------------------

def _pad_to(x, total, axis, fill=0.0):
    pad = total - x.shape[axis]
    if pad == 0:
        return x
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return jnp.pad(x, widths, constant_values=fill)


def _local_gram_rows(xblk, mblk, lLmb, lLmb0, lnug, *, ndev, kernel,
                     compute_dtype):
    """My (q, nb, n) rows of the masked nugget-included Gram stack.

    Cross-build against the all_gathered x plus the nugget diagonal on my
    global rows reproduces the kernel's same=True semantics
    (C = amp*((1-eta) C0 + eta I), reference covmat.py:45-53); padded
    rows/cols are zeroed via the mask.
    """
    nb = xblk.shape[0]
    n = nb * ndev
    idx = lax.axis_index(AXIS)
    x_full = lax.all_gather(xblk, AXIS).reshape(n, xblk.shape[1])
    m_full = lax.all_gather(mblk, AXIS).reshape(n)
    C = gram_stack(xblk, x_full, lLmb, lLmb0, lnug, same=False,
                   compute_dtype=compute_dtype, kind=kernel)  # (q, nb, n)
    eye_blk = _eye_rows(idx, nb, n, C.dtype)
    eta = (lnug / (1.0 + lnug)).astype(C.dtype)
    amp = lLmb0.astype(C.dtype)
    C = C + (amp * eta)[:, None, None] * eye_blk[None]
    C = C * mblk[None, :, None] * m_full[None, None, :]
    return C, eye_blk, x_full, m_full


def _local_gram_grads(xblk, x_full, mblk, m_full, eye_blk, lLmb, lLmb0,
                      lnug, Cbar, *, kernel):
    """psum-reduced (glens, gamp, gnug) for a row-local Gram cotangent.

    Cbar is the cotangent of the *masked, nugget-included* local rows;
    the cross part chains through the analytic kernel VJP, the manual
    nugget diagonal through its closed form.
    """
    Cbar = Cbar * mblk[None, :, None] * m_full[None, None, :]
    glens, gamp, gnug = gram_vjp(xblk, x_full, lLmb, lLmb0, lnug,
                                 same=False, cbar=Cbar, kind=kernel)
    # nugget diagonal: forward added amp*eta on my global diag entries
    dt = Cbar.dtype
    s = jnp.sum(Cbar * eye_blk[None].astype(dt), axis=(-2, -1))   # (q,)
    eta = (lnug / (1.0 + lnug)).astype(dt)
    amp = lLmb0.astype(dt)
    gamp = gamp + (eta * s).astype(gamp.dtype)
    gnug = gnug + (amp * s / jnp.square(1.0 + lnug.astype(dt))
                   ).astype(gnug.dtype)
    return (lax.psum(glens, AXIS), lax.psum(gamp, AXIS),
            lax.psum(gnug, AXIS))


# ---------------------------------------------------------------------------
# n-sharded full-data loss (custom VJP — memory-bounded backward)
# ---------------------------------------------------------------------------

def _nshard_full_fwd_local(xblk, mblk, a_blk, lLmb, lLmb0, lnug, D,
                           *, ndev, jitter, kernel, compute_dtype):
    """Per-device forward: my Gram rows -> distributed factor/solve ->
    per-component loss terms.  Returns (terms, LB rows, w rows)."""
    C, eye_blk, _, _ = _local_gram_rows(
        xblk, mblk, lLmb, lLmb0, lnug, ndev=ndev, kernel=kernel,
        compute_dtype=compute_dtype)
    Dm = D.astype(C.dtype)
    diag_vals = 1.0 + jitter * mblk                     # pad diag stays 1
    B = Dm[:, None, None] * C + diag_vals[None, :, None].astype(C.dtype) \
        * eye_blk[None]
    LB = _dist_cholesky_local(B, ndev)
    w = _dist_cho_solve_vec_local(LB, a_blk.astype(LB.dtype), ndev)
    # C a = (B a - (1+jitter) a) / D, avoiding a second stack
    a_full = _gather_vec(a_blk, B.shape[-1]).astype(B.dtype)
    Ba = jnp.einsum('qab,qb->qa', B, a_full)
    Ca = (Ba - (1.0 + jitter) * a_blk.astype(B.dtype)) / Dm[:, None]
    quad = lax.psum(jnp.sum((Ca * w).astype(jnp.float64), axis=-1), AXIS)
    logdet = _dist_chol_logdet_local(LB, ndev)
    terms = 0.5 * logdet - 0.5 * quad                   # (q,) f64
    return terms, LB, w


def _nshard_full_bwd_local(xblk, mblk, a_blk, lLmb, lLmb0, lnug, D,
                           LBblk, wblk, tbar,
                           *, ndev, jitter, kernel, compute_dtype):
    """Closed-form backward (mirrors likelihood._full_terms_vjp_bwd):
    dt/dC = 0.5 D B^{-1} - 0.5 w w^T, dt/da = -C w, from the saved
    distributed factor — per-device working set stays O(q·nb·n)."""
    q, nb, n = LBblk.shape
    idx = lax.axis_index(AXIS)
    dt = LBblk.dtype
    x_full = lax.all_gather(xblk, AXIS).reshape(n, xblk.shape[1])
    m_full = lax.all_gather(mblk, AXIS).reshape(n)
    eye_blk = _eye_rows(idx, nb, n, dt)
    w_full = _gather_vec(wblk, n)
    Binv_rows = _dist_chol_inverse_rows_local(LBblk, ndev)
    tb = tbar.astype(dt)
    Dm = D.astype(dt)
    # total dt/dC (chain through B = D C + (1+jit) I already folded in,
    # exactly as likelihood._full_terms_vjp_bwd)
    Cbar = tb[:, None, None] * (0.5 * Dm[:, None, None] * Binv_rows
                                - 0.5 * wblk[:, :, None] * w_full[:, None, :])
    glens, gamp, gnug = _local_gram_grads(
        xblk, x_full, mblk, m_full, eye_blk, lLmb, lLmb0, lnug, Cbar,
        kernel=kernel)
    # C w = (a - (1+jitter) w) / D (from B w = a)
    Cw = (a_blk.astype(dt) - (1.0 + jitter) * wblk) / Dm[:, None]
    abar = (-tb[:, None] * Cw).astype(a_blk.dtype)
    return (jnp.zeros_like(xblk), jnp.zeros_like(mblk), abar,
            glens.astype(lLmb.dtype), gamp.astype(lLmb0.dtype),
            gnug.astype(lnug.dtype), jnp.zeros_like(D))


def _shmap_full_fwd(mesh, ndev, jitter, kernel, compute_dtype):
    body = partial(_nshard_full_fwd_local, ndev=ndev, jitter=jitter,
                   kernel=kernel, compute_dtype=compute_dtype)
    qa = _qax(mesh)
    return jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(AXIS, None), P(AXIS), P(qa, AXIS),
                  P(qa, None), P(qa), P(qa), P(qa)),
        out_specs=(P(qa), P(qa, AXIS, None), P(qa, AXIS)))


def _shmap_full_bwd(mesh, ndev, jitter, kernel, compute_dtype):
    body = partial(_nshard_full_bwd_local, ndev=ndev, jitter=jitter,
                   kernel=kernel, compute_dtype=compute_dtype)
    qa = _qax(mesh)
    return jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(AXIS, None), P(AXIS), P(qa, AXIS),
                  P(qa, None), P(qa), P(qa), P(qa),
                  P(qa, AXIS, None), P(qa, AXIS), P(qa)),
        out_specs=(P(AXIS, None), P(AXIS), P(qa, AXIS),
                   P(qa, None), P(qa), P(qa), P(qa)))


@partial(jax.custom_vjp, nondiff_argnums=(0, 1, 2, 3))
def _full_terms_nsharded(mesh, jitter, kernel, compute_dtype,
                         xs, mask, a, lLmb, lLmb0, lnug, D):
    ndev = _n_size(mesh)
    terms, _, _ = _shmap_full_fwd(mesh, ndev, jitter, kernel, compute_dtype)(
        xs, mask, a, lLmb, lLmb0, lnug, D)
    return terms


def _full_terms_nsharded_fwd(mesh, jitter, kernel, compute_dtype,
                             xs, mask, a, lLmb, lLmb0, lnug, D):
    ndev = _n_size(mesh)
    terms, LB, w = _shmap_full_fwd(mesh, ndev, jitter, kernel,
                                   compute_dtype)(
        xs, mask, a, lLmb, lLmb0, lnug, D)
    return terms, (xs, mask, a, lLmb, lLmb0, lnug, D, LB, w)


def _full_terms_nsharded_bwd(mesh, jitter, kernel, compute_dtype, res, tbar):
    xs, mask, a, lLmb, lLmb0, lnug, D, LB, w = res
    ndev = _n_size(mesh)
    out = _shmap_full_bwd(mesh, ndev, jitter, kernel, compute_dtype)(
        xs, mask, a, lLmb, lLmb0, lnug, D, LB, w, tbar)
    return out


_full_terms_nsharded.defvjp(_full_terms_nsharded_fwd, _full_terms_nsharded_bwd)


def _full_terms_nsharded_raw(mesh, jitter, kernel, compute_dtype,
                             xs, mask, a, lLmb, lLmb0, lnug, D):
    """The same forward WITHOUT the custom VJP — autodiff goes through the
    unrolled distributed factorization.  Exists only for the memory A/B
    (benchmarks/nshard_memory.py, tests): every panel iteration's
    intermediates become backward residuals, per device."""
    ndev = _n_size(mesh)
    terms, _, _ = _shmap_full_fwd(mesh, ndev, jitter, kernel, compute_dtype)(
        xs, mask, a, lLmb, lLmb0, lnug, D)
    return terms


def neglpost_full_nsharded(free: Pm.FreeParams, data: FullData, mesh: Mesh,
                           compute_dtype=None, jitter: float = 0.0,
                           kernel: str = 'matern32',
                           _custom_vjp: bool = True):
    """Full-data loss with the n axis sharded over the mesh.

    Semantics identical to ``likelihood.neglpost_full`` (reference
    lcgp.py:635-666); n is padded to a multiple of the n-axis size with
    loss-neutral rows (C zeroed, unit diagonal, zero data weight).  On a
    2-D ('comp','n') mesh the q axis is additionally padded/sharded over
    'comp'.  _custom_vjp=False switches to plain autodiff through the
    unrolled distributed factorization (memory A/B only).
    """
    ndev = _n_size(mesh)
    n = data.xs.shape[0]
    q = data.phi.shape[1]
    n_pad = -(-n // ndev) * ndev
    qp = _q_pad(mesh, q)

    lLmb, lLmb0, lsig_g, lnug = Pm.constrain(free)
    lsig = Pm.expand_sigma(lsig_g, data.sigma_map)
    sigma = jnp.exp(lsig)

    psi_c = data.phi / jnp.sqrt(sigma)[:, None]             # (p, q)
    a = (data.ys.T @ psi_c).T                               # (q, n)

    xs = _pad_to(data.xs, n_pad, axis=0, fill=0.5)
    mask = _pad_to(jnp.ones((n,), dtype=data.xs.dtype), n_pad, axis=0)
    a = _pad_to(a, n_pad, axis=1)
    lLmb, lLmb0, lnug = _pad_q_params(mesh, lLmb, lLmb0, lnug)
    a = _pad_q(a, qp)
    D = _pad_q(data.diag_D, qp, fill=1.0)   # D=1 keeps the padded B=C+I PSD

    terms_fn = _full_terms_nsharded if _custom_vjp else \
        _full_terms_nsharded_raw
    terms = terms_fn(mesh, jitter, kernel, compute_dtype,
                     xs, mask, a, lLmb, lLmb0, lnug, D)

    nlp = jnp.sum(terms[:q]).astype(data.ys.dtype)
    nlp += 0.5 * n * jnp.sum(lsig)
    nlp += 0.5 * jnp.sum(jnp.square(data.ys / jnp.sqrt(sigma)[:, None]))
    return nlp


# ---------------------------------------------------------------------------
# n-sharded replication loss (custom VJP)
# ---------------------------------------------------------------------------

def _nshard_rep_fwd_local(xblk, mblk, lamblk, jit_q, b_blk, lLmb, lLmb0,
                          lnug, *, ndev, kernel, compute_dtype):
    """Rep-path per-device forward: my rows of A = C + diag(lam + jit),
    distributed factor/solve, per-component partial terms.
    Returns (terms, LT rows, u rows, Cu rows)."""
    C, eye_blk, _, _ = _local_gram_rows(
        xblk, mblk, lLmb, lLmb0, lnug, ndev=ndev, kernel=kernel,
        compute_dtype=compute_dtype)
    # padded rows get a clean unit diagonal (zero logdet/quad contribution)
    diag_vals = jnp.where(mblk[None, :] > 0,
                          lamblk.astype(C.dtype) + jit_q.astype(C.dtype),
                          1.0)                                # (q, nb)
    A = C + diag_vals[:, :, None] * eye_blk[None]
    LT = _dist_cholesky_local(A, ndev)
    lb = lamblk.astype(LT.dtype) * b_blk.astype(LT.dtype)
    u = _dist_cho_solve_vec_local(LT, lb, ndev)
    Cu = lb - diag_vals * u                                   # (S b) rows
    quad = lax.psum(jnp.sum((b_blk.astype(LT.dtype) * Cu)
                            .astype(jnp.float64), axis=-1), AXIS)
    logdet = _dist_chol_logdet_local(LT, ndev)
    terms = -0.5 * quad + 0.5 * logdet                        # (q,) f64
    return terms, LT, u, Cu


def _nshard_rep_bwd_local(xblk, mblk, lamblk, jit_q, b_blk, lLmb, lLmb0,
                          lnug, LTblk, ublk, Cublk, tbar,
                          *, ndev, kernel, compute_dtype):
    """Closed-form backward (mirrors likelihood._rep_terms_vjp_bwd):
    dt/dC = 0.5 T - 0.5 u u^T with T = A^{-1}, dt/db = -C u."""
    q, nb, n = LTblk.shape
    idx = lax.axis_index(AXIS)
    dt = LTblk.dtype
    x_full = lax.all_gather(xblk, AXIS).reshape(n, xblk.shape[1])
    m_full = lax.all_gather(mblk, AXIS).reshape(n)
    eye_blk = _eye_rows(idx, nb, n, dt)
    u_full = _gather_vec(ublk, n)
    Tinv_rows = _dist_chol_inverse_rows_local(LTblk, ndev)
    tb = tbar.astype(dt)
    Cbar = tb[:, None, None] * (0.5 * Tinv_rows
                                - 0.5 * ublk[:, :, None] * u_full[:, None, :])
    glens, gamp, gnug = _local_gram_grads(
        xblk, x_full, mblk, m_full, eye_blk, lLmb, lLmb0, lnug, Cbar,
        kernel=kernel)
    bbar = (-tb[:, None] * Cublk).astype(b_blk.dtype)
    return (jnp.zeros_like(xblk), jnp.zeros_like(mblk),
            jnp.zeros_like(lamblk), jnp.zeros_like(jit_q), bbar,
            glens.astype(lLmb.dtype), gamp.astype(lLmb0.dtype),
            gnug.astype(lnug.dtype))


def _shmap_rep_fwd(mesh, ndev, kernel, compute_dtype):
    body = partial(_nshard_rep_fwd_local, ndev=ndev, kernel=kernel,
                   compute_dtype=compute_dtype)
    qa = _qax(mesh)
    return jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(AXIS, None), P(AXIS), P(qa, AXIS), P(qa, None),
                  P(qa, AXIS), P(qa, None), P(qa), P(qa)),
        out_specs=(P(qa), P(qa, AXIS, None), P(qa, AXIS), P(qa, AXIS)))


def _shmap_rep_bwd(mesh, ndev, kernel, compute_dtype):
    body = partial(_nshard_rep_bwd_local, ndev=ndev, kernel=kernel,
                   compute_dtype=compute_dtype)
    qa = _qax(mesh)
    return jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(AXIS, None), P(AXIS), P(qa, AXIS), P(qa, None),
                  P(qa, AXIS), P(qa, None), P(qa), P(qa),
                  P(qa, AXIS, None), P(qa, AXIS), P(qa, AXIS),
                  P(qa)),
        out_specs=(P(AXIS, None), P(AXIS), P(qa, AXIS), P(qa, None),
                   P(qa, AXIS), P(qa, None), P(qa), P(qa)))


@partial(jax.custom_vjp, nondiff_argnums=(0, 1, 2))
def _rep_terms_nsharded(mesh, kernel, compute_dtype,
                        xs, mask, lam, jit_q, b, lLmb, lLmb0, lnug):
    ndev = _n_size(mesh)
    terms, _, _, _ = _shmap_rep_fwd(mesh, ndev, kernel, compute_dtype)(
        xs, mask, lam, jit_q, b, lLmb, lLmb0, lnug)
    return terms


def _rep_terms_nsharded_fwd(mesh, kernel, compute_dtype,
                            xs, mask, lam, jit_q, b, lLmb, lLmb0, lnug):
    ndev = _n_size(mesh)
    terms, LT, u, Cu = _shmap_rep_fwd(mesh, ndev, kernel, compute_dtype)(
        xs, mask, lam, jit_q, b, lLmb, lLmb0, lnug)
    return terms, (xs, mask, lam, jit_q, b, lLmb, lLmb0, lnug, LT, u, Cu)


def _rep_terms_nsharded_bwd(mesh, kernel, compute_dtype, res, tbar):
    xs, mask, lam, jit_q, b, lLmb, lLmb0, lnug, LT, u, Cu = res
    ndev = _n_size(mesh)
    return _shmap_rep_bwd(mesh, ndev, kernel, compute_dtype)(
        xs, mask, lam, jit_q, b, lLmb, lLmb0, lnug, LT, u, Cu, tbar)


_rep_terms_nsharded.defvjp(_rep_terms_nsharded_fwd, _rep_terms_nsharded_bwd)


def neglpost_rep_nsharded(free: Pm.FreeParams, data: RepData, mesh: Mesh,
                          compute_dtype=None, jitter: float = 0.0,
                          kernel: str = 'matern32'):
    """Replication loss with the unique-point axis sharded over the mesh.

    Semantics identical to ``likelihood.neglpost_rep`` (reference
    lcgp.py:554-630); n padded with loss-neutral rows.
    """
    ndev = _n_size(mesh)
    n = data.xs.shape[0]
    p = data.ybar.shape[0]
    n_pad = -(-n // ndev) * ndev

    lLmb, lLmb0, lsig_g, lnug = Pm.constrain(free)
    lsig = Pm.expand_sigma(lsig_g, data.sigma_map)
    sigma_raw = jnp.exp(lsig)
    r = data.r

    sigma_var_used = sigma_raw / jnp.square(data.scale)
    sigma_inv_sqrt = data.scale / jnp.sqrt(sigma_raw)

    # diagonal data terms: plain n-sums, no sharding needed
    nlp = 0.5 * jnp.sum(r * jnp.sum(
        jnp.square(data.ybar * sigma_inv_sqrt[:, None]), axis=0))
    nlp += 0.5 * n * jnp.sum(jnp.log(sigma_var_used))
    nlp += -0.5 * p * jnp.sum(jnp.log(r))

    v = data.phi * sigma_inv_sqrt[:, None]
    b = r[None, :] * (data.ybar.T @ v).T                       # (q, n)
    D = data.diag_D
    lam = 1.0 / (D[:, None] * r[None, :])                      # (q, n)
    nlp += 0.5 * jnp.sum(jnp.log(D[:, None] * r[None, :]))
    # amplitude-scaled jitter, matching likelihood._rep_terms_fwd_impl
    jit_q = jitter * (1.0 + lLmb0[:, None])                    # (q, 1)

    xs = _pad_to(data.xs, n_pad, axis=0, fill=0.5)
    mask = _pad_to(jnp.ones((n,), dtype=data.xs.dtype), n_pad, axis=0)
    b = _pad_to(b, n_pad, axis=1)
    lam = _pad_to(lam, n_pad, axis=1, fill=1.0)

    q = data.phi.shape[1]
    qp = _q_pad(mesh, q)
    lLmb_p, lLmb0_p, lnug_p = _pad_q_params(mesh, lLmb, lLmb0, lnug)
    b = _pad_q(b, qp)
    lam = _pad_q(lam, qp, fill=1.0)   # padded comp: A = C + I, well-posed
    jit_q = _pad_q(jit_q, qp)

    comp_terms = _rep_terms_nsharded(mesh, kernel, compute_dtype,
                                     xs, mask, lam, jit_q, b,
                                     lLmb_p, lLmb0_p, lnug_p)
    nlp += jnp.sum(comp_terms[:q]).astype(nlp.dtype)
    return nlp / n


def make_loss(submethod: str, data, mesh: Mesh, compute_dtype=None,
              jitter: float = 0.0, kernel: str = 'matern32'):
    """AuxLoss(free, data) with mesh closed over (same contract as
    likelihood.make_loss, n-sharded execution).  The data pytree rides
    through optimizer jits as a runtime argument, not an HLO constant —
    at pod-scale n the constant form exceeds compile-payload limits
    (fit/auxloss.py)."""
    from ..fit.auxloss import AuxLoss
    loss_fn = (neglpost_rep_nsharded if submethod == 'rep'
               else neglpost_full_nsharded)

    def loss(free, data):
        return loss_fn(free, data, mesh, compute_dtype=compute_dtype,
                       jitter=jitter, kernel=kernel)
    return AuxLoss(loss, data, aux_sharding=data_shardings(mesh, data))


def make_nsharded_value_and_grad(mesh: Mesh, data,
                                 compute_dtype=None, jitter: float = 0.0,
                                 kernel: str = 'matern32'):
    """jit(value_and_grad) of the n-sharded loss over the mesh (full or
    rep data)."""
    from ..fit.auxloss import split_aux
    sub = 'rep' if isinstance(data, RepData) else 'full'
    loss = make_loss(sub, data, mesh, compute_dtype=compute_dtype,
                     jitter=jitter, kernel=kernel)
    # one-time, mesh-laid-out transfer of the data pytree — NOT re-sent
    # host->device on every evaluation
    fn, aux = split_aux(loss)
    vg = jax.jit(jax.value_and_grad(fn))
    return lambda free: vg(free, aux)


# ---------------------------------------------------------------------------
# n-sharded predictive path
# ---------------------------------------------------------------------------

class NShardAux(NamedTuple):
    """Distributed predictive state: the factor stays row-sharded on the
    mesh; ``u`` are the dual weights (CinvM), row-sharded."""
    u: jnp.ndarray       # (q, n_pad) sharded over 'n'
    L: jnp.ndarray       # (q, n_pad, n_pad) rows sharded over 'n'
    kind: str = 'full'   # 'full' (L = chol(D C + (1+jit) I)) or
    #                      'rep'  (L = chol(C + diag(lam + jit)))


def _nshard_aux_full_local(xblk, mblk, a_blk, lLmb, lLmb0, lnug, D,
                           *, ndev, jitter, kernel, compute_dtype):
    _, LB, w = _nshard_full_fwd_local(
        xblk, mblk, a_blk, lLmb, lLmb0, lnug, D, ndev=ndev, jitter=jitter,
        kernel=kernel, compute_dtype=compute_dtype)
    return w, LB


def _nshard_aux_rep_local(xblk, mblk, lamblk, jit_q, b_blk, lLmb, lLmb0,
                          lnug, *, ndev, kernel, compute_dtype):
    _, LT, u, _ = _nshard_rep_fwd_local(
        xblk, mblk, lamblk, jit_q, b_blk, lLmb, lLmb0, lnug, ndev=ndev,
        kernel=kernel, compute_dtype=compute_dtype)
    return u, LT


@partial(jax.jit, static_argnames=('mesh', 'compute_dtype', 'jitter',
                                   'kernel'))
def _aux_rep_nsharded_jit(free, data, *, mesh, compute_dtype, jitter,
                          kernel):
    ndev = _n_size(mesh)
    n = data.xs.shape[0]
    n_pad = -(-n // ndev) * ndev
    lLmb, lLmb0, lsig_g, lnug = Pm.constrain(free)
    lsig = Pm.expand_sigma(lsig_g, data.sigma_map)
    sigma_raw = jnp.exp(lsig)

    xs = _pad_to(data.xs, n_pad, axis=0, fill=0.5)
    mask = _pad_to(jnp.ones((n,), dtype=data.xs.dtype), n_pad, axis=0)

    sigma_inv_sqrt = data.scale / jnp.sqrt(sigma_raw)
    v = data.phi * sigma_inv_sqrt[:, None]
    b = data.r[None, :] * (data.ybar.T @ v).T
    lam = 1.0 / (data.diag_D[:, None] * data.r[None, :])
    jit_q = jitter * (1.0 + lLmb0[:, None])
    b = _pad_to(b, n_pad, axis=1)
    lam = _pad_to(lam, n_pad, axis=1, fill=1.0)
    qp = _q_pad(mesh, data.phi.shape[1])
    lLmb, lLmb0, lnug = _pad_q_params(mesh, lLmb, lLmb0, lnug)
    b, lam, jit_q = _pad_q(b, qp), _pad_q(lam, qp, fill=1.0), \
        _pad_q(jit_q, qp)
    qa = _qax(mesh)
    body = partial(_nshard_aux_rep_local, ndev=ndev, kernel=kernel,
                   compute_dtype=compute_dtype)
    fn = jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(AXIS, None), P(AXIS), P(qa, AXIS), P(qa, None),
                  P(qa, AXIS), P(qa, None), P(qa), P(qa)),
        out_specs=(P(qa, AXIS), P(qa, AXIS, None)))
    return fn(xs, mask, lam, jit_q, b, lLmb, lLmb0, lnug)


@partial(jax.jit, static_argnames=('mesh', 'compute_dtype', 'jitter',
                                   'kernel'))
def _aux_full_nsharded_jit(free, data, *, mesh, compute_dtype, jitter,
                           kernel):
    ndev = _n_size(mesh)
    n = data.xs.shape[0]
    n_pad = -(-n // ndev) * ndev
    lLmb, lLmb0, lsig_g, lnug = Pm.constrain(free)
    lsig = Pm.expand_sigma(lsig_g, data.sigma_map)
    sigma_raw = jnp.exp(lsig)

    xs = _pad_to(data.xs, n_pad, axis=0, fill=0.5)
    mask = _pad_to(jnp.ones((n,), dtype=data.xs.dtype), n_pad, axis=0)

    psi_c = data.phi / jnp.sqrt(sigma_raw)[:, None]
    a = _pad_to((data.ys.T @ psi_c).T, n_pad, axis=1)
    qp = _q_pad(mesh, data.phi.shape[1])
    lLmb, lLmb0, lnug = _pad_q_params(mesh, lLmb, lLmb0, lnug)
    a = _pad_q(a, qp)
    D = _pad_q(data.diag_D, qp, fill=1.0)
    qa = _qax(mesh)
    body = partial(_nshard_aux_full_local, ndev=ndev, jitter=jitter,
                   kernel=kernel, compute_dtype=compute_dtype)
    fn = jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(AXIS, None), P(AXIS), P(qa, AXIS),
                  P(qa, None), P(qa), P(qa), P(qa)),
        out_specs=(P(qa, AXIS), P(qa, AXIS, None)))
    return fn(xs, mask, a, lLmb, lLmb0, lnug, D)


def compute_aux_nsharded(free: Pm.FreeParams, data, mesh: Mesh,
                         compute_dtype=None, jitter: float = 0.0,
                         kernel: str = 'matern32') -> NShardAux:
    """Distributed predictive aux (dual weights + row-sharded factor).

    Full path: the same B = D C + (1+jitter) I factor as the loss;
    u = B^{-1} a is exactly the CinvM of ``predict.compute_aux_full``.
    Rep path: u = (C + Lam)^{-1} Lam b (``predict.compute_aux_rep``).
    Jitted with the mesh static so repeated aux refreshes reuse the
    compiled executable.
    """
    if isinstance(data, RepData):
        u, L = _aux_rep_nsharded_jit(free, data, mesh=mesh,
                                     compute_dtype=compute_dtype,
                                     jitter=jitter, kernel=kernel)
        return NShardAux(u=u, L=L, kind='rep')
    u, L = _aux_full_nsharded_jit(free, data, mesh=mesh,
                                  compute_dtype=compute_dtype,
                                  jitter=jitter, kernel=kernel)
    return NShardAux(u=u, L=L, kind='full')


def _nshard_predict_local(xblk, mblk, Lblk, ublk, x0s, lLmb, lLmb0, lnug,
                          *, ndev, kernel, compute_dtype):
    """Per-device predict: my columns of the (q, n0, n) cross-cov against
    my dual-weight rows (mean) and a distributed forward substitution for
    the variance reduction.  Outputs replicated (q, n0)."""
    c0 = gram_stack(x0s, xblk, lLmb, lLmb0, lnug, same=False,
                    compute_dtype=compute_dtype, kind=kernel)  # (q, n0, nb)
    c0 = c0 * mblk[None, None, :]
    ghat = lax.psum(jnp.einsum('qob,qb->qo', c0, ublk.astype(c0.dtype)),
                    AXIS)
    M = _dist_solve_rows_local(Lblk, jnp.swapaxes(c0, -1, -2)
                               .astype(Lblk.dtype), ndev)      # (q, nb, n0)
    ssq = lax.psum(jnp.sum(jnp.square(M), axis=1), AXIS)       # (q, n0)
    return ghat, ssq


@partial(jax.jit, static_argnames=('mesh', 'kind', 'compute_dtype',
                                   'kernel'))
def _predict_nsharded_jit(free, xs_train, u, L, x0s, diag_D, *,
                          mesh, kind, compute_dtype, kernel):
    ndev = _n_size(mesh)
    n = xs_train.shape[0]
    n_pad = L.shape[-1]
    q = diag_D.shape[0]
    lLmb, lLmb0, _, lnug = Pm.constrain(free)
    lLmb_p, lLmb0_p, lnug_p = _pad_q_params(mesh, lLmb, lLmb0, lnug)

    xs = _pad_to(xs_train, n_pad, axis=0, fill=0.5)
    mask = _pad_to(jnp.ones((n,), dtype=xs_train.dtype), n_pad, axis=0)

    qa = _qax(mesh)
    body = partial(_nshard_predict_local, ndev=ndev, kernel=kernel,
                   compute_dtype=compute_dtype)
    fn = jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(AXIS, None), P(AXIS), P(qa, AXIS, None),
                  P(qa, AXIS), P(None, None), P(qa, None), P(qa),
                  P(qa)),
        out_specs=(P(qa, None), P(qa, None)))
    ghat, ssq = fn(xs, mask, L, u, x0s, lLmb_p, lLmb0_p, lnug_p)
    ghat, ssq = ghat[:q], ssq[:q]

    c00 = matern32_diag(x0s, lLmb0).astype(ssq.dtype)
    if kind == 'full':
        gvar = c00 - diag_D[:, None].astype(ssq.dtype) * ssq
    else:
        gvar = c00 - ssq
    return ghat, gvar


def predict_nsharded_core(free: Pm.FreeParams, data, aux: NShardAux,
                          x0s, mesh: Mesh, compute_dtype=None,
                          jitter: float = 0.0, kernel: str = 'matern32'):
    """(ghat, gvar) at standardized x0s with the n axis distributed.

    Matches ``predict.predict_full_core`` / ``predict_rep_core``:
    full:  gvar = c00 - D * sum(M^2),  M = LB^{-1} c0^T
    rep:   gvar = c00 - sum(M^2),      M = LT^{-1} c0^T
    Jitted with the mesh static, so repeated predicts (serving) reuse the
    compiled executable.
    """
    return _predict_nsharded_jit(free, data.xs, aux.u, aux.L, x0s,
                                 data.diag_D, mesh=mesh, kind=aux.kind,
                                 compute_dtype=compute_dtype, kernel=kernel)
