"""The LCGP model class — reference-compatible API over the functional core.

Public surface mirrors the reference class (reference lcgp.py:19-930):
constructor flags, ``fit``/``loss``/``predict``/``get_param``/``preprocess``,
standardization helpers, and the same (p, n) output layout.  NumPy in, JAX
arrays out.

Differences (all documented in DESIGN.md):
- auxiliary predictive quantities are recomputed whenever parameters change
  (pure function of (params, data)) instead of a NaN-sentinel cache;
- the constructor does not print latent variances (exposed as ``g_var``);
- ``fit(verbose=True)`` actually reports optimizer progress;
- extra: ``precision='fast'`` (f32 compute), on-device optimizers,
  ``save``/``load``.
"""
from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

import jax
import jax.numpy as jnp

from ..config import dtype_for, jitter_for
from ..ops import linalg as lk_linalg
from ..fit.scipy_lbfgs import minimize_lbfgs
from ..fit.optax_fit import minimize_adam, minimize_lbfgs_jax
from . import basis as basis_mod
from . import likelihood as lik
from . import params as P
from . import predict as pred
from . import transforms as tx
from .replication import group_replicates


class LCGP:
    """Latent Component Gaussian Process.

    Supports two training/prediction paths:
      - submethod='full': uses all observations (x, y)
      - submethod='rep' : groups replicated x rows, uses (x_unique, ybar)
    """

    def __init__(self,
                 y=None,
                 x=None,
                 q: Optional[int] = None,
                 var_threshold: Optional[float] = None,
                 diag_error_structure: Optional[list] = None,
                 parameter_clamp_flag: bool = False,
                 robust_mean: bool = True,
                 submethod: str = 'full',
                 rep_standardize_ybar: bool = True,
                 verbose: bool = False,
                 precision: str = 'high',
                 q_chunk: Optional[int] = None,
                 kernel: str = 'matern32',
                 inducing=None,
                 n_chunk: Optional[int] = None):
        if y is None or x is None:
            raise ValueError('LCGP requires both y (p, n) and x (n, d).')

        self.verbose = verbose
        self.robust_mean = robust_mean
        self.rep_standardize_ybar = rep_standardize_ybar
        self.parameter_clamp_flag = parameter_clamp_flag
        # precision='auto' resolves to 'mixed' at n >= _AUTO_MIXED_N and
        # 'high' below; resolution happens once n is known (rep grouping
        # can shrink it).
        self.precision = precision
        if precision == 'auto':
            self._compute_dtype = None
            self._jitter = jitter_for('high')
        else:
            self._compute_dtype = (None if precision == 'high'
                                   else dtype_for(precision))
            self._jitter = jitter_for(precision)
        # memory-bounded training: process latent components in chunks of
        # q_chunk (None = choose automatically from the device-memory model
        # once q is known; pass an int to override, 0/negative to force
        # unchunked)
        self._q_chunk_arg = q_chunk
        self.q_chunk = q_chunk
        if kernel not in ('matern32', 'matern52', 'rbf'):
            raise ValueError(
                "kernel must be 'matern32', 'matern52', or 'rbf'")
        self.kernel = kernel

        self.x = self._verify_data_types(x)
        self.y = self._verify_data_types(y)

        self.method = 'LCGP'
        if submethod not in ('full', 'rep'):
            raise ValueError("Invalid submethod. Choices are 'full' or 'rep'.")
        self.submethod = submethod
        self.submethod_loss_map = {'full': self.neglpost, 'rep': self.neglpost_rep}
        self.submethod_predict_map = {'full': self.predict_full,
                                      'rep': self.predict_rep}

        if (q is not None) and (var_threshold is not None):
            raise ValueError('Include only q or var_threshold but not both.')
        self.q = q
        self.var_threshold = var_threshold

        self.n, self.d, self.p = self.verify_dim(self.y, self.x)

        self.x_orig = self.x
        self.y_orig = self.y

        # x standardization (always on the full inputs, lcgp.py:97).
        # xnorm (an O(n^2) host diagnostic nothing consumes, reference
        # lcgp.py:304-310) is computed lazily on first access — at n=50k
        # the eager version burned ~1e9 NumPy ops per construction.
        self.x, self.x_min, self.x_max = tx.standardize_x(self.x)
        self._xnorm_cache = None

        self._rep_initialized = False

        if self.submethod == 'rep':
            rep = group_replicates(np.asarray(self.x_orig), np.asarray(self.y_orig))
            n_unique = rep.x_unique.shape[0]

            x_unique = jnp.asarray(rep.x_unique)
            self.x_unique = x_unique
            self.x_unique_s = (x_unique - self.x_min) / (self.x_max - self.x_min)
            self.group_ids = jnp.asarray(rep.group_ids)
            self.r = jnp.asarray(rep.r)
            self.ybar = jnp.asarray(rep.ybar)

            ybar_mean, ybar_std = tx.center_spread(
                self.ybar, self.robust_mean, floor_zero_spread=True)
            self.ybar_mean = ybar_mean
            self.ybar_std = ybar_std
            self.ybar_s = (self.ybar - ybar_mean) / ybar_std

            self.n = int(n_unique)
            self._rep_initialized = True
        else:
            self.y, self.ymean, self.ystd, _ = self.init_standard_y(self.y)

        if self.precision == 'auto':
            self.precision = ('mixed' if self.n >= self._AUTO_MIXED_N
                              else 'high')
            self._compute_dtype = (None if self.precision == 'high'
                                   else dtype_for(self.precision))
            self._jitter = jitter_for(self.precision)
            if self.verbose:
                print(f"[lcgp_tpu] precision='auto' -> "
                      f"{self.precision!r} (n={self.n})")

        # SVD basis (lcgp.py:454-485); q resolved on host, shapes static after
        b = basis_mod.init_phi(np.asarray(self._get_phi_input()),
                               q=self.q, var_threshold=var_threshold)
        self.g = jnp.asarray(b.g)
        self.phi = jnp.asarray(b.phi)
        self.diag_D = jnp.asarray(b.diag_D)
        self.q = b.q
        self.g_var = jnp.asarray(b.g_var)
        if self.verbose:
            print('variance of latent g:', np.asarray(self.g_var))

        if self._q_chunk_arg is None:
            self.q_chunk = self._auto_q_chunk(int(self.q), int(self.n),
                                              self.precision)
        elif self._q_chunk_arg <= 0:
            self.q_chunk = None

        if diag_error_structure is None:
            self.diag_error_structure = [1] * int(self.p)
        else:
            self.diag_error_structure = diag_error_structure
        self.verify_error_structure(self.diag_error_structure, self.y)
        self._sigma_map = jnp.asarray(P.sigma_index_map(self.diag_error_structure))

        # data-driven init (lcgp.py:490-513); note self.y is raw in rep mode
        self._free = P.init_values(np.asarray(self.x), np.asarray(self.y),
                                   self.q, self.diag_error_structure)
        self._params_version = 0
        self._aux = None
        self._aux_version = -1
        # ('n',)-mesh for n-axis distributed execution (set by
        # fit(mesh=...) or set_mesh); loss/fit/aux/predict all route
        # through parallel/nshard when present.
        self._n_mesh = None
        # FITC negative-variance clamp statistics from the last predict
        # (health_check surfaces these via the _fitc_clamp_stats property;
        # None = exact path or no predict yet).  Stored as a device-side
        # (count, worst, total) triple and only materialized on access, so
        # batched predicts pay zero per-batch host syncs (ADVICE r3).
        self._fitc_clamp_accum = None
        self._in_batched_predict = False
        self._predict_pad_cols = 0

        self._data = self._build_data()

        # Optional FITC/Nystrom inducing-point approximation (extra beyond
        # the reference — its own Nystrom draft is dead code, covmat.py:57-93).
        # inducing: int m (greedy farthest-point subset of the standardized
        # design) or an (m, d) array in original x units.
        self._z = None
        if inducing is not None:
            from . import sparse
            xs_std = np.asarray(self._data.xs)
            if np.ndim(inducing) == 0:
                m = int(inducing)
                if m >= xs_std.shape[0]:
                    raise ValueError(
                        f'inducing={m} must be < n={xs_std.shape[0]} '
                        '(use the exact path instead)')
                z = sparse.select_inducing(xs_std, m)
            else:
                z = np.asarray(inducing, dtype=np.float64)
                if z.ndim < 2:
                    z = z[:, None]
                z = (z - np.asarray(self.x_min)) / \
                    (np.asarray(self.x_max) - np.asarray(self.x_min))
            self._z = jnp.asarray(z)

        # FITC n-axis streaming (models/sparse._fitc_stream): None = auto
        # (chunk when the (q, n, m) panel outgrows the backward's device-
        # memory share), int = block size, 0/negative = force un-chunked.
        self._n_chunk_arg = n_chunk
        self.n_chunk = None
        if self._z is not None:
            if n_chunk is None:
                self.n_chunk = self._auto_n_chunk(
                    int(self.q), int(self.n), int(self._z.shape[0]),
                    self.precision)
            elif n_chunk > 0:
                self.n_chunk = int(n_chunk)

    # ------------------------------------------------------------------
    # Data containers for the functional core
    # ------------------------------------------------------------------
    def _build_data(self):
        if self.submethod == 'rep':
            use_std = self.rep_standardize_ybar
            scale = self.ybar_std[:, 0] if use_std else jnp.ones(int(self.p),
                                                                dtype=self.ybar.dtype)
            return lik.RepData(
                xs=self.x_unique_s,
                ybar=self.ybar_s if use_std else self.ybar,
                scale=scale,
                r=jnp.asarray(self.r, dtype=self.ybar.dtype),
                phi=self.phi,
                diag_D=self.diag_D,
                sigma_map=self._sigma_map,
            )
        return lik.FullData(
            xs=self.x,
            ys=self.y,
            phi=self.phi,
            diag_D=self.diag_D,
            sigma_map=self._sigma_map,
        )

    # ------------------------------------------------------------------
    # Display
    # ------------------------------------------------------------------
    def __repr__(self):
        lLmb, lLmb0, lsigma2s, lnugGPs = self.get_param()

        def fmt(a):
            return np.array2string(np.asarray(a), precision=4, threshold=8)

        params = (f"\t\tLatent GP lengthscale (lLmb):\t{fmt(lLmb)}\n"
                  f"\t\tLatent GP scale (lLmb0):\t{fmt(lLmb0)}\n"
                  f"\t\tDiagonal error log-variance:\t{fmt(lsigma2s)}\n"
                  f"\t\tLatent GP nugget scale:\t{fmt(lnugGPs)}")
        return ('LCGP(\n'
                f'\tsubmethod:\t{self.submethod}\n'
                f'\toutput dimension:\t{int(self.p)}\n'
                f'\tnumber of latent components:\t{int(self.q)}\n'
                f'\tparameter_clamping:\t{self.parameter_clamp_flag}\n'
                f'\trobust_standardization:\t{self.robust_mean}\n'
                f'\tdiagonal_error structure:\t{self.diag_error_structure}\n'
                f'\tparameters:\t\n{params}\n)')

    # ------------------------------------------------------------------
    # Utils: type checks, dims, transforms (lcgp.py:248-324)
    # ------------------------------------------------------------------
    @staticmethod
    def _verify_data_types(t):
        t = jnp.asarray(t, dtype=jnp.float64)
        if t.ndim < 2:
            t = t[:, None]
        return t

    def verify_dim(self, y, x):
        p, ny = y.shape[0], y.shape[1]
        nx, d = x.shape[0], x.shape[1]
        assert ny == nx, ('Number of inputs (x) differs from number of outputs '
                          '(y), y.shape[1] != x.shape[0]')
        return int(nx), int(d), int(p)

    @staticmethod
    def verify_error_structure(diag_error_structure, y):
        assert sum(diag_error_structure) == y.shape[0], \
            'Sum of error_structure should equal the output dimension.'
        assert all(g > 0 for g in diag_error_structure), \
            'Error structure groups must be positive.'

    def tx_x(self, xs):
        return xs * (self.x_max - self.x_min) + self.x_min

    def tx_y(self, ys):
        """Inverse y-standardization.  Full mode un-standardizes by
        ymean/ystd; rep mode by ybar_mean/ybar_std (identity when
        rep_standardize_ybar=False).  The reference's version raises
        AttributeError on the rep path (its ymean/ystd are never set)."""
        if self.submethod == 'rep':
            if self.rep_standardize_ybar:
                return ys * self.ybar_std + self.ybar_mean
            return ys
        return ys * self.ystd + self.ymean

    @property
    def xnorm(self):
        """Per-dim mean positive pairwise |x_i - x_j| (reference
        lcgp.py:304-310).  Dead diagnostic in the reference too; computed
        lazily so construction stays O(n)."""
        if self._xnorm_cache is None:
            self._xnorm_cache = jnp.asarray(tx.xnorm(np.asarray(self.x_orig)))
        return self._xnorm_cache

    @staticmethod
    def init_standard_x(x):
        xs, x_min, x_max = tx.standardize_x(x)
        xnorm = jnp.asarray(tx.xnorm(np.asarray(x)))
        return xs, x_min, x_max, x, xnorm

    def init_standard_y(self, y):
        ys, c, s = tx.standardize_y(y, self.robust_mean)
        return ys, c, s, y

    # ------------------------------------------------------------------
    # Replication structures (lcgp.py:397-434)
    # ------------------------------------------------------------------
    @property
    def R(self):
        """diag(r) as a dense matrix — materialized on demand only."""
        return jnp.diag(jnp.asarray(self.r, dtype=jnp.float64))

    def preprocess(self, y_raw=None, x_raw=None):
        """Replication structures as the reference's 12-tuple
        (lcgp.py:397-426)."""
        x_raw = self.x_orig if x_raw is None else self._verify_data_types(x_raw)
        y_raw = self.y_orig if y_raw is None else self._verify_data_types(y_raw)
        rep = group_replicates(np.asarray(x_raw), np.asarray(y_raw))
        n_unique = rep.x_unique.shape[0]
        x_unique = jnp.asarray(rep.x_unique)
        x_unique_s = (x_unique - self.x_min) / (self.x_max - self.x_min)
        r = jnp.asarray(rep.r)
        R = jnp.diag(jnp.asarray(r, dtype=jnp.float64))
        ybar = jnp.asarray(rep.ybar)
        ybar_mean, ybar_std = tx.center_spread(ybar, self.robust_mean,
                                               floor_zero_spread=True)
        ybar_s = (ybar - ybar_mean) / ybar_std
        return (x_unique, x_unique_s, jnp.asarray(rep.group_ids), r, R,
                ybar, ybar_s, ybar_mean, ybar_std,
                n_unique, x_unique.shape[1], ybar.shape[0])

    def _ensure_replication(self):
        if not self._rep_initialized:
            (self.x_unique, self.x_unique_s, self.group_ids, self.r, _,
             self.ybar, self.ybar_s, self.ybar_mean, self.ybar_std,
             _, _, _) = self.preprocess()
            self._rep_initialized = True

    def _get_phi_input(self):
        if self.submethod != 'rep':
            return self.y
        if getattr(self, 'rep_standardize_ybar', True) and hasattr(self, 'ybar_s'):
            return self.ybar_s
        if hasattr(self, 'ybar'):
            return self.ybar
        return self.y

    # ------------------------------------------------------------------
    # Parameters
    # ------------------------------------------------------------------
    @property
    def lLmb(self):
        return P.constrain(self._free)[0]

    @property
    def lLmb0(self):
        return P.constrain(self._free)[1]

    @property
    def lsigma2s(self):
        return P.constrain(self._free)[2]

    @property
    def lnugGPs(self):
        return P.constrain(self._free)[3]

    def get_param(self):
        """(lLmb, lLmb0, per-output lsigma2s, lnugGPs) — grouped error
        log-variances expanded to (p,) (lcgp.py:515-532)."""
        lLmb, lLmb0, lsig_g, lnug = P.constrain(self._free)
        return lLmb, lLmb0, P.expand_sigma(lsig_g, self._sigma_map), lnug

    def set_params(self, lLmb=None, lLmb0=None, lsigma2s=None, lnugGPs=None):
        """Assign constrained parameter values (grouped lsigma2s)."""
        cur = P.constrain(self._free)
        vals = [cur[0] if lLmb is None else jnp.asarray(lLmb, dtype=jnp.float64),
                cur[1] if lLmb0 is None else jnp.asarray(lLmb0, dtype=jnp.float64),
                cur[2] if lsigma2s is None else jnp.asarray(lsigma2s, dtype=jnp.float64),
                cur[3] if lnugGPs is None else jnp.asarray(lnugGPs, dtype=jnp.float64)]
        self._free = P.unconstrain(*vals)
        self._params_version += 1

    def init_params(self):
        """Re-run the data-driven init (lcgp.py:490-513)."""
        self._free = P.init_values(np.asarray(self.x), np.asarray(self.y),
                                   self.q, self.diag_error_structure)
        self._params_version += 1

    # ------------------------------------------------------------------
    # Training
    # ------------------------------------------------------------------
    def loss(self):
        if self.precision == 'mixed':
            # out-of-fit loss evaluations (e.g. at externally-set params)
            # must also see conditioning-appropriate forward refinement;
            # ratchet up only, so the jit cache is stable
            self._sync_refine_steps()
        try:
            return self.submethod_loss_map[self.submethod]()
        except KeyError:
            raise ValueError("Invalid submethod. Choices are 'full' or 'rep'.")

    def _sync_refine_steps(self):
        from ..ops import mixed as mixed_ops
        cur = mixed_ops.parse_refine(self._compute_dtype)
        rec = self.recommended_refine_steps()
        if cur is not None and rec > cur:
            self._set_refine_steps(rec)

    def neglpost(self):
        if self._z is not None:
            if self._n_mesh is not None:
                from ..parallel import fitc_shard
                return fitc_shard.neglpost_full_fitc_nsharded(
                    self._free, self._data, self._z, self._n_mesh,
                    compute_dtype=self._compute_dtype, kernel=self.kernel)
            from . import sparse
            return sparse.neglpost_full_fitc(
                self._free, self._data, self._z,
                compute_dtype=self._compute_dtype, kernel=self.kernel,
                n_chunk=self.n_chunk)
        if self._n_mesh is not None:
            from ..parallel import nshard
            return nshard.neglpost_full_nsharded(
                self._free, self._data, self._n_mesh,
                compute_dtype=self._compute_dtype, jitter=self._jitter,
                kernel=self.kernel)
        return lik.neglpost_full(self._free, self._data,
                                 compute_dtype=self._compute_dtype,
                                 jitter=self._jitter, q_chunk=self.q_chunk,
                                 kernel=self.kernel)

    def neglpost_rep(self):
        if self._z is not None:
            if self._n_mesh is not None:
                from ..parallel import fitc_shard
                return fitc_shard.neglpost_rep_fitc_nsharded(
                    self._free, self._data, self._z, self._n_mesh,
                    compute_dtype=self._compute_dtype, kernel=self.kernel)
            from . import sparse
            return sparse.neglpost_rep_fitc(
                self._free, self._data, self._z,
                compute_dtype=self._compute_dtype, kernel=self.kernel,
                n_chunk=self.n_chunk)
        if self._n_mesh is not None:
            from ..parallel import nshard
            return nshard.neglpost_rep_nsharded(
                self._free, self._data, self._n_mesh,
                compute_dtype=self._compute_dtype, jitter=self._jitter,
                kernel=self.kernel)
        return lik.neglpost_rep(self._free, self._data,
                                compute_dtype=self._compute_dtype,
                                jitter=self._jitter, q_chunk=self.q_chunk,
                                kernel=self.kernel)

    def set_mesh(self, mesh):
        """Attach (or detach with None) an ('n',) or ('comp','n') device
        mesh: subsequent loss/fit/aux/predict run n-axis distributed
        (parallel/nshard).  The exact single-device path is capped by one
        device's memory (the (q_chunk, n, n) stacks of _auto_q_chunk's
        model); the n-sharded path scales that limit linearly with the
        mesh size.  A 2-D
        ('comp','n') mesh (parallel.nshard.make_nc_mesh) additionally
        shards the q components over 'comp' groups, keeping the
        distributed factorization's sequential panel loop short at large
        device counts (both the exact and FITC paths)."""
        if mesh is not None:
            from ..parallel import nshard
            if not nshard.is_n_mesh(mesh):
                raise ValueError(
                    f"set_mesh needs an ('n',) or ('comp','n') mesh "
                    f"(parallel.nshard.make_n_mesh / make_nc_mesh); got "
                    f"axis names {tuple(mesh.axis_names)!r}")
        # Inducing-point (FITC) models shard too: the (q, n, m) Woodbury
        # panel is n-bounded in memory, and parallel/fitc_shard distributes
        # its rows exactly (loss/aux identical up to float reordering).
        self._n_mesh = mesh
        self._aux = None
        self._aux_version = -1

    # ------------------------------------------------------------------
    # Mixed-precision refinement control (adaptive escalation)
    # ------------------------------------------------------------------
    def recommended_refine_steps(self) -> int:
        """Refinement-step count the conditioning of the *current*
        parameters calls for on the 'mixed' path.

        Proxy: per-component upper bound on the factorization target's
        condition number — full: cond_k <= 1 + D_k amp_k n (B = D C + I,
        ||C||_2 <= amp n, lmin(B) >= 1); rep: (amp_k n + max lam_k)/min
        lam_k (A = C + diag(lam)).  One refinement step contracts the
        factor error by ~eps32*cond, so the needed steps grow by one per
        ~1/eps32-factor (~decade-and-a-half) of conditioning.
        """
        import math
        _, lLmb0, _, _ = P.constrain(self._free)
        amp = np.asarray(lLmb0, dtype=float)
        D = np.asarray(self.diag_D, dtype=float)
        n = float(self.n)
        if self.submethod == 'rep':
            r = np.asarray(self.r, dtype=float)
            lam = 1.0 / (D[:, None] * r[None, :])          # (q, n)
            cond = np.max((amp * n + lam.max(axis=1)) / lam.min(axis=1))
        else:
            cond = float(np.max(1.0 + D * amp * n))
        if not math.isfinite(cond) or cond <= 3e5:
            return 2
        if cond <= 3e7:
            return 3
        if cond <= 3e9:
            return 4
        return 5

    def _set_refine_steps(self, k: int):
        from ..ops import mixed as mixed_ops
        self._compute_dtype = 'mixed' if k == mixed_ops.DEFAULT_REFINE_STEPS \
            else f'mixed:{int(k)}'

    def _loss_fn(self, compute_dtype='model', jitter=None):
        """Loss closure; compute_dtype/jitter default to the model's
        precision policy but can be overridden (the hybrid fit's f32
        stage)."""
        if compute_dtype == 'model':
            compute_dtype = self._compute_dtype
        if jitter is None:
            jitter = self._jitter
        if self._z is not None:
            if self._n_mesh is not None:
                from ..parallel import fitc_shard
                return fitc_shard.make_loss(
                    self.submethod, self._data, self._z, self._n_mesh,
                    compute_dtype=compute_dtype, kernel=self.kernel)
            from . import sparse
            from ..fit.auxloss import AuxLoss
            fitc = (sparse.neglpost_rep_fitc if self.submethod == 'rep'
                    else sparse.neglpost_full_fitc)
            # AuxLoss threads the training tensors through the optimizer
            # jits as a runtime argument, not a closure constant (see
            # fit/auxloss.py)
            return AuxLoss(
                lambda free, data: fitc(free, data, self._z,
                                        compute_dtype=compute_dtype,
                                        kernel=self.kernel,
                                        n_chunk=self.n_chunk),
                self._data)
        return lik.make_loss(self.submethod, self._data,
                             compute_dtype=compute_dtype,
                             jitter=jitter, q_chunk=self.q_chunk,
                             kernel=self.kernel)

    # At-and-above this many (unique) design points fit() stops letting the
    # optimizer run unbounded (plateau stop): at the borehole config
    # (n=1000) uncapped scipy L-BFGS-B spent ~13x the evaluations for the
    # same prediction quality.  Chosen on earlier hardware, not measured on
    # the H100 (ROADMAP Q1.6).
    _AUTO_ONDEVICE_N = 512
    # precision='auto' switches to 'mixed' at this n; the mixed path's
    # f64-grade-loss criterion is validated at the headline configs
    # (benchmarks/validate_mixed.py).  Chosen on earlier hardware for
    # speed, not measured on the H100 (ROADMAP Q1.4).
    _AUTO_MIXED_N = 2048

    # Training-working-set fraction of the device's usable memory
    # (``memory_stats()['bytes_limit']``, i.e. what the JAX allocator may
    # hand out).  The rest is XLA scratch and the data terms, which scale
    # with the working set.  PERF.md records its check against the
    # measured peak on the H100 (ROADMAP Q1.5).
    _HBM_BUDGET_FRACTION = 0.635
    # CPU budget: chunk decisions there only affect test determinism,
    # never feasibility, so they stay fixed regardless of host memory.
    _HBM_BUDGET_DEFAULT = 10e9

    @classmethod
    def _hbm_budget_bytes(cls) -> float:
        """Per-device working-set budget the auto-chunk planners size against.

        Resolution order: ``LCGP_TPU_HBM_BUDGET_BYTES`` env override -> the
        CPU default -> ``_HBM_BUDGET_FRACTION`` of the accelerator's
        ``memory_stats()['bytes_limit']``.  An accelerator that does not
        report its limit is an error: a guessed size would either OOM or
        chunk for no reason.
        """
        env = os.environ.get('LCGP_TPU_HBM_BUDGET_BYTES')
        if env:
            return float(env)
        dev = jax.local_devices()[0]
        if dev.platform == 'cpu':
            return cls._HBM_BUDGET_DEFAULT
        limit = (dev.memory_stats() or {}).get('bytes_limit')
        if not limit:
            raise RuntimeError(
                f'{dev.platform} device {dev.device_kind!r} reports no '
                "memory_stats()['bytes_limit']; set LCGP_TPU_HBM_BUDGET_BYTES "
                'or pass q_chunk= / n_chunk= explicitly')
        return cls._HBM_BUDGET_FRACTION * float(limit)

    @staticmethod
    def _q_peak_bytes(q: int, qc: int, n: int, precision: str) -> float:
        """The planner's peak model for one exact-path loss+grad: ~8
        transient (qc,n,n) stacks during a chunk's forward+backward plus a
        (q,n,n) term -> (8*qc + q) * n^2 * itemsize.  Since the gradient-
        in-forward VJP (models/likelihood.py) the cross-chunk residuals are
        O(q n) vectors, so the +q*n^2 term is headroom.

        An upper bound on an H100 (benchmarks/planner_memory.py, XLA's
        compiled memory): q=20 f64 at n=4096 takes 78 (n,n) stacks
        unchunked (model: 180), 31.5 at q_chunk=5 (60), 6.4 at q_chunk=1
        (28); at n=8192, 44 at q_chunk=5 (60).  The measured device peak
        is the compiled figure plus ~0.4 GB of data."""
        itemsize = 4 if precision == 'fast' else 8
        return float((8 * qc + q) * n * n * itemsize)

    @classmethod
    def _auto_q_chunk(cls, q: int, n: int, precision: str):
        """Pick the component-chunk size so the loss+grad working set
        (``_q_peak_bytes``) fits the device budget."""
        budget = cls._hbm_budget_bytes()
        if cls._q_peak_bytes(q, q, n, precision) <= budget:
            return None                       # unchunked fits
        for qc in range(q - 1, 0, -1):
            if q % qc == 0 and cls._q_peak_bytes(q, qc, n, precision) <= budget:
                return qc
        return 1

    @staticmethod
    def _fitc_peak_bytes(q: int, n: int, m: int, precision: str) -> float:
        """Peak model for one un-chunked FITC loss+grad: 9 (q, n, m)
        panels.  Measured on an H100 (benchmarks/planner_memory.py, XLA's
        compiled memory, q=5, m=512, f64): 8.1 panels at n=50,000 and at
        n=200,000 (33.2 GB); the predictive aux takes 3.1."""
        itemsize = 4 if precision == 'fast' else 8
        return float(9 * q * n * m * itemsize)

    @classmethod
    def _auto_n_chunk(cls, q: int, n: int, m: int, precision: str):
        """Pick the FITC n-axis block size (models/sparse._fitc_stream).

        Chunk once ``_fitc_peak_bytes`` outgrows the device budget; the
        streamed block is sized to a ~256 MB working set — large enough to
        keep the panel GEMMs compute-bound, small enough that the scan's
        rematerialized backward stays a rounding error in device memory.  The 256 MB block
        was chosen on earlier hardware, not measured on the H100
        (ROADMAP Q1.9)."""
        if cls._fitc_peak_bytes(q, n, m, precision) <= cls._hbm_budget_bytes():
            return None                       # un-chunked backward fits
        per_point = q * m * (4 if precision == 'fast' else 8)
        block = max(4096, int(2 ** np.floor(
            np.log2(256 * 2**20 / per_point))))
        return min(block, n)

    def fit(self, verbose: bool = False, method: str = 'auto', **kwargs):
        """Optimize hyperparameters.

        method='auto'   : 'scipy' (uncapped, parity semantics) for small
                          problems.  At n >= 512: precision='fast' uses the
                          on-device 'lbfgs-jax' (f32 evals are cheap);
                          'high'/'mixed' use scipy with a *plateau stop*
                          (halt when the relative loss decrease over the
                          last plateau_patience=20 iters < plateau_rtol=
                          1e-8) — at the borehole config (n=1000) the
                          uncapped optimizer spends thousands of evals
                          on negligible loss gains.  maxiter=2000 remains
                          as a safety cap; stopping on it is announced and
                          recorded in _fit_result.stop_reason.
        method='scipy'  : scipy L-BFGS-B over jitted value_and_grad (the
                          reference's semantics, lcgp.py:537-540; use for
                          parity runs).
        method='adam'   : on-device Adam (kwargs: steps, learning_rate).
        method='lbfgs-jax': on-device optax L-BFGS (kwargs: maxiter, tol).
        method='hybrid' : f32 on-device L-BFGS to convergence, then an f64
                          (model-precision) polish (kwargs: maxiter for the
                          f32 stage, polish_maxiter, default 60) — f64
                          L-BFGS quality at a fraction of the f64 evals.

        mesh=...        : a jax.sharding.Mesh from parallel.make_mesh runs
                          the optimization sharded over it.  method='auto'
                          or 'adam' runs the sharded on-device Adam loop
                          (kwargs: steps, learning_rate, plateau_rtol,
                          callback, checkpoint_path); method='scipy' or
                          'lbfgs-jax' runs L-BFGS over the same sharded
                          loss through the single-device drivers — full
                          optimizer-family parity.
        """
        # mid-fit checkpointing: periodically persist the free parameters
        # (+ step/loss) so a long fit survives preemption; restore with
        # restore_checkpoint().  Wired through the optimizer block callback.
        checkpoint_path = kwargs.pop('checkpoint_path', None)
        if checkpoint_path is not None:
            # np.savez appends '.npz' when missing; normalize once so
            # restore_checkpoint(same_path) finds the file
            checkpoint_path = self._norm_ckpt_path(checkpoint_path)
            user_cb = kwargs.pop('callback', None)

            def _ckpt_cb(step, loss, params):
                np.savez(checkpoint_path, step=step, loss=loss,
                         free_lLmb=np.asarray(params.lLmb),
                         free_lLmb0=np.asarray(params.lLmb0),
                         free_lsigma2s=np.asarray(params.lsigma2s),
                         free_lnugGPs=np.asarray(params.lnugGPs))
                if user_cb is not None:
                    user_cb(step, loss, params)

            kwargs['callback'] = _ckpt_cb

        mesh = kwargs.pop('mesh', None)
        if mesh is not None:
            from ..parallel import nshard
            axes = tuple(mesh.axis_names)
            if nshard.is_n_mesh(mesh):
                # n-axis distributed path: loss/grad via the blocked
                # distributed Cholesky (parallel/nshard.py); callbacks
                # (incl. checkpointing) work — the optimizer loop is the
                # same host-synced one as single-device.  ('comp','n')
                # additionally shards q over comp groups (set_mesh
                # validates FITC compatibility).
                return self._fit_nsharded(mesh, verbose=verbose,
                                          method=method, **kwargs)
            if axes != ('comp', 'out'):
                raise ValueError(
                    f"fit(mesh=...) needs axis names ('n',), "
                    f"('comp','n') or ('comp', 'out'); got {axes!r}.  "
                    "Build one with parallel.make_mesh, parallel.nshard."
                    "make_n_mesh or parallel.nshard.make_nc_mesh.")
            # ('comp','out') mesh: optimizer parity with single-device —
            # method='auto'/'adam' runs the sharded on-device Adam loop
            # (steps/learning_rate/block_steps kwargs); method='scipy' or
            # 'lbfgs-jax' runs genuine L-BFGS over the same sharded loss
            # (parallel.mesh.make_sharded_loss) through the exact
            # single-device drivers.  Callbacks (incl. mid-fit
            # checkpointing, wired above), plateau_rtol= (opt-in,
            # patience-guarded on the non-monotone Adam loop), and
            # _fit_result fun/nit/stop_reason work on every method.
            if self._z is not None:
                raise ValueError(
                    "inducing-point (FITC) models don't support the "
                    "('comp','out') mesh (parallel.fit_sharded optimizes "
                    "the exact loss); use an ('n',) mesh — "
                    "fit(mesh=parallel.nshard.make_n_mesh()) shards the "
                    "FITC Woodbury panel (parallel/fitc_shard).")
            if method not in ('auto', 'adam'):
                from ..parallel import mesh as mesh_mod
                loss_fn = mesh_mod.make_sharded_loss(
                    mesh, self._data, compute_dtype=self._compute_dtype,
                    jitter=self._jitter, kernel=self.kernel)
                self._run_optimizer(loss_fn, method, verbose, **kwargs)
                # gather the (possibly comp-sharded) leaves so downstream
                # single-device predict is layout-agnostic
                self._free = P.FreeParams(*(jnp.asarray(np.asarray(a))
                                            for a in self._free))
                return
            kwargs.setdefault('verbose', verbose or self.verbose)
            from .. import parallel
            free, res = parallel.fit_sharded(self._data, self._free, mesh,
                                             **kwargs)
            # gather the sharded leaves so downstream single-device predict
            # is layout-agnostic
            self._free = P.FreeParams(*(jnp.asarray(np.asarray(a))
                                        for a in free))
            self._params_version += 1
            self._fit_result = res
            return
        if method == 'auto':
            if self.n >= self._AUTO_ONDEVICE_N:
                if self.precision == 'fast':
                    method = 'lbfgs-jax'
                    kwargs.setdefault('plateau_rtol', 1e-8)
                else:
                    # convergence-based stop instead of a hand-tuned
                    # maxiter: halt when the relative loss decrease over
                    # the last `plateau_patience` iters drops below
                    # plateau_rtol; maxiter stays only as a safety cap.
                    method = 'scipy'
                    kwargs.setdefault('plateau_patience', 20)
                    kwargs.setdefault('plateau_rtol', 1e-8)
                    kwargs.setdefault('maxiter', 2000)
                if self.precision == 'high' and \
                        self.n >= self._AUTO_MIXED_N and \
                        (verbose or self.verbose) and \
                        not getattr(self, '_mixed_hint_shown', False):
                    self._mixed_hint_shown = True
                    print(f"[lcgp_tpu.fit] hint: at n={self.n}, "
                          "precision='mixed' (or 'auto') reaches an f64-"
                          "grade fitted loss with f32 factorizations "
                          "(validated: benchmarks/validate_mixed.py)")
            else:
                method = 'scipy'
            if verbose or self.verbose:
                print(f'[lcgp_tpu.fit] auto-selected method={method!r} '
                      f'(n={self.n}, {kwargs})')
        if method == 'hybrid':
            fast_loss = self._loss_fn(compute_dtype=jnp.float32, jitter=1e-6)
            polish_maxiter = kwargs.pop('polish_maxiter', 60)
            # the f32 stage only needs to get close; the polish finishes
            # the convergence in model precision, so cap the cheap stage
            kwargs.setdefault('maxiter', 200)
            res1 = minimize_lbfgs_jax(fast_loss, self._free, **kwargs)
            # the f64 polish keeps the callback (checkpointing covers the
            # expensive stage too, ADVICE r2)
            res = minimize_lbfgs_jax(self._loss_fn(), res1.params,
                                     maxiter=polish_maxiter,
                                     callback=kwargs.get('callback'))
            self._free = res.params
            self._params_version += 1
            self._fit_result = res
            return
        if self.precision == 'mixed':
            from ..ops import mixed as mixed_ops
            # start at the step count the current conditioning calls for
            self._set_refine_steps(max(
                self.recommended_refine_steps(),
                mixed_ops.parse_refine(self._compute_dtype)))
        self._run_optimizer(self._loss_fn(), method, verbose, **kwargs)
        if self.precision == 'mixed':
            # conditioning grows as amplitudes fit; escalate the refinement
            # and re-converge (the plateau stop makes re-runs cheap when
            # the optimum is unchanged) until the fitted conditioning is
            # within the refinement's regime (VERDICT r2 weak #4).
            from ..ops import mixed as mixed_ops
            for _ in range(3):
                cur = mixed_ops.parse_refine(self._compute_dtype)
                rec = self.recommended_refine_steps()
                if rec <= cur:
                    break
                self._set_refine_steps(rec)
                if verbose or self.verbose:
                    print(f'[lcgp_tpu.fit] mixed refinement escalated to '
                          f'{rec} steps (fitted conditioning); '
                          're-converging')
                self._run_optimizer(self._loss_fn(), method, verbose,
                                    **kwargs)
        return

    def _run_optimizer(self, loss_fn, method, verbose, **kwargs):
        if method == 'scipy':
            res = minimize_lbfgs(loss_fn, self._free,
                                 verbose=verbose or self.verbose, **kwargs)
        elif method == 'adam':
            res = minimize_adam(loss_fn, self._free, **kwargs)
        elif method == 'lbfgs-jax':
            res = minimize_lbfgs_jax(loss_fn, self._free, **kwargs)
        else:
            raise ValueError(f'Unknown fit method {method!r}.')
        self._free = res.params
        self._params_version += 1
        self._fit_result = res
        reason = getattr(res, 'stop_reason', None)
        if reason == 'cap':
            # always announce a budget-capped stop (never silent, ADVICE r2)
            print(f'[lcgp_tpu.fit] stopped on the iteration cap '
                  f'(nit={int(res.nit)}) before convergence; pass maxiter= '
                  'to raise the budget or method="scipy" for an uncapped '
                  'parity run.')
        elif (verbose or self.verbose) and reason is not None:
            print(f'[lcgp_tpu.fit] converged: stop_reason={reason!r} '
                  f'nit={int(res.nit)} loss={float(res.fun):.8g}')
        return res

    def _fit_nsharded(self, mesh, verbose=False, method='auto', **kwargs):
        """Fit with the n axis distributed over an ('n',) mesh.

        The loss/gradient run through parallel/nshard's distributed blocked
        Cholesky with its memory-bounded custom-VJP backward; the optimizer
        loop (and callbacks, incl. checkpointing) is the same host-synced
        one as single-device fit.  Also arms the model's n-sharded
        aux/predict path (set_mesh).  precision='mixed' degrades to full
        f64 factorizations on this path (correct, just without the
        refinement speedup); 'fast' (f32) is supported.
        """
        self.set_mesh(mesh)
        if self._z is not None:
            from ..parallel import fitc_shard
            loss_fn = fitc_shard.make_loss(
                self.submethod, self._data, self._z, mesh,
                compute_dtype=self._compute_dtype, kernel=self.kernel)
        else:
            from ..parallel import nshard
            loss_fn = nshard.make_loss(self.submethod, self._data, mesh,
                                       compute_dtype=self._compute_dtype,
                                       jitter=self._jitter,
                                       kernel=self.kernel)
        if method == 'auto':
            if self.precision == 'fast':
                method = 'lbfgs-jax'
                kwargs.setdefault('plateau_rtol', 1e-8)
            else:
                method = 'scipy'
                kwargs.setdefault('plateau_patience', 20)
                kwargs.setdefault('plateau_rtol', 1e-8)
                kwargs.setdefault('maxiter', 2000)
            if verbose or self.verbose:
                print(f'[lcgp_tpu.fit] n-sharded over {mesh.devices.size} '
                      f'devices; auto-selected method={method!r}')
        return self._run_optimizer(loss_fn, method, verbose, **kwargs)

    @staticmethod
    def _norm_ckpt_path(path):
        path = str(path)
        return path if path.endswith('.npz') else path + '.npz'

    def refine_inducing(self, steps: int = 200, learning_rate: float = 5e-3,
                        joint: bool = True, verbose: bool = False):
        """Gradient-refine the FITC inducing locations ``z`` (greedy
        farthest-point init) by minimizing the FITC loss — the standard
        next step for FITC quality after subset selection.

        joint=True optimizes z together with the hyperparameters (Adam);
        joint=False holds the hyperparameters fixed and moves only z.
        Returns the final loss.  The reference's abandoned Nyström draft
        (covmat.py:57-93) had no counterpart of this.
        """
        if self._z is None:
            raise ValueError('refine_inducing requires an inducing-point '
                             'model (construct with inducing=...)')
        if self._n_mesh is not None:
            from ..parallel import fitc_shard as _fs
            mesh = self._n_mesh

            def fitc(free, data, z, compute_dtype=None, kernel='matern32'):
                fn = (_fs.neglpost_rep_fitc_nsharded
                      if self.submethod == 'rep'
                      else _fs.neglpost_full_fitc_nsharded)
                return fn(free, data, z, mesh,
                          compute_dtype=compute_dtype, kernel=kernel)
        else:
            from . import sparse
            _fn = (sparse.neglpost_rep_fitc if self.submethod == 'rep'
                   else sparse.neglpost_full_fitc)

            def fitc(free, data, z, compute_dtype=None, kernel='matern32'):
                return _fn(free, data, z, compute_dtype=compute_dtype,
                           kernel=kernel, n_chunk=self.n_chunk)

        # AuxLoss: data rides as a runtime jit argument (never an HLO
        # constant) — same compile-payload reasoning as _loss_fn
        from ..fit.auxloss import AuxLoss
        if joint:
            def loss(tree, data):
                return fitc(tree['free'], data, tree['z'],
                            compute_dtype=self._compute_dtype,
                            kernel=self.kernel)
            tree0 = {'free': self._free, 'z': self._z}
        else:
            def loss(tree, data):
                return fitc(self._free, data, tree['z'],
                            compute_dtype=self._compute_dtype,
                            kernel=self.kernel)
            tree0 = {'z': self._z}

        res = minimize_adam(AuxLoss(loss, self._data), tree0, steps=steps,
                            learning_rate=learning_rate, verbose=verbose)
        # z stays unconstrained: the kernel is defined everywhere and
        # projecting back to [0,1]^d post-hoc would undo the optimization
        self._z = res.params['z']
        if joint:
            self._free = res.params['free']
        self._params_version += 1
        return float(res.fun)

    def restore_checkpoint(self, path):
        """Load free parameters from a fit(checkpoint_path=...) snapshot;
        returns (step, loss) recorded at the snapshot."""
        z = np.load(self._norm_ckpt_path(path), allow_pickle=False)
        self._free = P.FreeParams(jnp.asarray(z['free_lLmb']),
                                  jnp.asarray(z['free_lLmb0']),
                                  jnp.asarray(z['free_lsigma2s']),
                                  jnp.asarray(z['free_lnugGPs']))
        self._params_version += 1
        return int(z['step']), float(z['loss'])

    # ------------------------------------------------------------------
    # Prediction
    # ------------------------------------------------------------------
    def _ensure_aux(self):
        # Under 'mixed' the full/rep predictive aux uses the same refined
        # factorization as the training loss (ops/mixed.cholesky_mixed +
        # cho_solve_vec_refined): f64-grade results — same accuracy class
        # validated to <=1e-8 by benchmarks/validate_mixed.py, on the SAME
        # factorands (I + D C, C + Lam).  Its speed against f64 is not
        # measured on the H100 (ROADMAP Q1.4).  The distributed (nshard)
        # and FITC factorizations don't take the sentinel: nshard stays f64;
        # FITC's (m, m) systems are f64 by design (sparse.py).
        aux_dtype = self._compute_dtype
        if self.precision == 'mixed' and (self._n_mesh is not None
                                          or self._z is not None):
            aux_dtype = None
        if self._aux is None or self._aux_version != self._params_version:
            if self._z is not None and self._n_mesh is not None:
                from ..parallel import fitc_shard
                self._aux = fitc_shard.compute_aux_fitc_nsharded(
                    self._free, self._data, self._z, self.submethod,
                    self._n_mesh, compute_dtype=aux_dtype,
                    kernel=self.kernel)
            elif self._z is not None:
                from . import sparse
                self._aux = sparse.compute_aux_fitc(
                    self._free, self._data, self._z, self.submethod,
                    compute_dtype=aux_dtype, kernel=self.kernel,
                    n_chunk=self.n_chunk)
            elif self._n_mesh is not None:
                from ..parallel import nshard
                self._aux = nshard.compute_aux_nsharded(
                    self._free, self._data, self._n_mesh,
                    compute_dtype=aux_dtype, jitter=self._jitter,
                    kernel=self.kernel)
            elif self.submethod == 'rep':
                self._aux = pred.compute_aux_rep(
                    self._free, self._data, compute_dtype=aux_dtype,
                    jitter=self._jitter, kernel=self.kernel,
                    q_chunk=self.q_chunk)
            else:
                self._aux = pred.compute_aux_full(
                    self._free, self._data, compute_dtype=aux_dtype,
                    jitter=self._jitter, kernel=self.kernel,
                    q_chunk=self.q_chunk)
            self._aux_version = self._params_version
        return self._aux

    def compute_aux_predictive_quantities(self):
        if self.submethod == 'rep':
            return self._compute_aux_predictive_quantities_rep()
        self._aux = None
        self._ensure_aux()

    def _compute_aux_predictive_quantities_rep(self):
        self._aux = None
        self._ensure_aux()

    @staticmethod
    def _is_nshard_aux(aux):
        from ..parallel.nshard import NShardAux
        return isinstance(aux, NShardAux)

    @property
    def CinvMs(self):
        aux = self._ensure_aux()
        if hasattr(aux, 'CinvM'):
            return aux.CinvM
        if self._is_nshard_aux(aux):
            # distributed dual weights: trim the mesh padding (gathers).
            # Both axes can be padded — n to the n-axis size, q to the
            # comp-axis size on a ('comp','n') mesh (neutral components).
            return aux.u[:int(self.q), :int(self.n)]
        return aux.u          # FITC aux stores the dual weights as ``u``

    def _dense_factor(self, aux):
        """The (q, n, n) Cholesky factor regardless of execution mode.
        For n-sharded aux this gathers and trims the padding — the
        leading principal block of the padded factor IS the unpadded
        factor (pad rows are decoupled identity rows), and padded
        components (comp-mesh q padding) are trailing and sliced away."""
        if self._is_nshard_aux(aux):
            n = int(self.n)
            return aux.L[:int(self.q), :n, :n]
        return aux.LB if hasattr(aux, 'LB') else aux.LT

    @property
    def Ths(self):
        """Full path: the reference's Th_k matrices (lcgp.py:709-715) — the
        symmetric square root of D_k (I + D_k C_k)^{-1}.

        The hot paths never materialize these (they use the Cholesky factor
        ``LBs``); this accessor reconstructs the reference quantity exactly,
        via one batched eigh, so user code that consumed Th_k numerically
        keeps working."""
        if self.submethod == 'rep' or self._z is not None:
            return None
        aux = self._ensure_aux()
        LB = self._dense_factor(aux)
        B = LB @ jnp.swapaxes(LB, -1, -2)              # (q, n, n)
        wB, U = jnp.linalg.eigh(B)                     # B = U diag(wB) U^T
        scal = jnp.sqrt(self.diag_D[:, None].astype(wB.dtype) / wB)
        return jnp.einsum('qij,qj,qkj->qik', U, scal, U)

    @property
    def Tks(self):
        """Rep path: the reference's T_k = C^{-1} - C^{-1}(C^{-1}+d_k R)^{-1}
        C^{-1} (lcgp.py:783-788), equal by the matrix-inversion lemma to
        (C_k + (d_k R)^{-1})^{-1}.  Reconstructed on access from the stored
        Cholesky factor ``LTs`` (the hot paths never form the inverse)."""
        if self.submethod != 'rep' or self._z is not None:
            return None
        aux = self._ensure_aux()
        LT = self._dense_factor(aux)
        n = LT.shape[-1]
        eye = jnp.broadcast_to(jnp.eye(n, dtype=LT.dtype), LT.shape)
        return lk_linalg.cho_solve(LT, eye)

    @property
    def LBs(self):
        """Full path: chol(I + D_k C_k) stack — the factor the fast paths
        actually use (Th_k^2 = D_k (I + D_k C_k)^{-1})."""
        if self.submethod == 'rep' or self._z is not None:
            return None
        return self._dense_factor(self._ensure_aux())

    @property
    def LTs(self):
        """Rep path: chol(C_k + diag(1/(d_k r))) stack."""
        if self.submethod != 'rep' or self._z is not None:
            return None
        return self._dense_factor(self._ensure_aux())

    @property
    def mks(self):
        if self.submethod != 'rep' or self._z is not None:
            return None
        aux = self._ensure_aux()
        if self._is_nshard_aux(aux):
            return None       # diagnostic not materialized distributed
        return aux.mks

    @property
    def psi_c(self):
        if self.submethod != 'rep' or self._z is not None:
            return None
        aux = self._ensure_aux()
        if self._is_nshard_aux(aux):
            return None
        return aux.psi_c

    def predict(self, x0, return_fullcov: bool = False,
                batch_size: Optional[int] = None):
        """Predict at x0 (n0, d) -> tuple of (p, n0) arrays.

        batch_size: evaluate test points in chunks of this many (bounds the
        (q, n0, n) cross-covariance working set for production-scale n0);
        None predicts in one shot.  Not combined with return_fullcov.
        """
        x0 = self._verify_data_types(x0)
        try:
            predict_call = self.submethod_predict_map[self.submethod]
        except KeyError:
            raise KeyError("Invalid submethod.  Choices are 'full' or 'rep'.")
        if batch_size is None:
            return predict_call(x0=x0, return_fullcov=return_fullcov)
        if return_fullcov:
            raise ValueError('batch_size is not supported with '
                             'return_fullcov=True.')
        # With batch_size set, EVERY request goes through the fixed-shape
        # chunk/pad path — including n0 < batch_size.  (A fast path that
        # skipped padding for small inputs compiled a fresh program per
        # distinct n0.)
        n0 = x0.shape[0]
        # pad the final chunk so every batch compiles to one shape; clamp
        # stats accumulate across batches (one reset here, not per batch)
        self._fitc_clamp_accum = None
        self._in_batched_predict = True
        try:
            chunks = []
            for s in range(0, n0, batch_size):
                blk = x0[s:s + batch_size]
                pad = batch_size - blk.shape[0]
                if pad:
                    blk = jnp.concatenate([blk, blk[-1:].repeat(pad, axis=0)])
                # clamp stats must count the user's points, not the
                # duplicated padding rows (health_check's frac gate)
                self._predict_pad_cols = pad
                out = predict_call(x0=blk, return_fullcov=False)
                chunks.append([o[:, :batch_size - pad] if pad else o
                               for o in out])
        finally:
            self._in_batched_predict = False
            self._predict_pad_cols = 0
        return tuple(jnp.concatenate([c[i] for c in chunks], axis=1)
                     for i in range(3))

    def _standardize_x0(self, x0):
        x0 = self._verify_data_types(x0)
        return (x0 - self.x_min) / (self.x_max - self.x_min)

    def _record_clamp_stats(self, count, worst, total):
        """Accumulate FITC variance-clamp statistics device-side.

        Jit-safe (ADVICE r3 high): inside a trace (serving's fused predict
        jits a function that calls _latent_predict) count/worst are Tracers
        and recording is skipped — the clamp itself stays in-graph.  Outside
        traces the device scalars are accumulated without host transfer;
        materialization happens once, lazily, in the _fitc_clamp_stats
        property (ADVICE r3 low: no per-batch device sync)."""
        if isinstance(count, jax.core.Tracer):
            return
        prev = self._fitc_clamp_accum
        if prev is None:
            self._fitc_clamp_accum = (count, worst, int(total))
        else:
            self._fitc_clamp_accum = (prev[0] + count,
                                      jnp.minimum(prev[1], worst),
                                      prev[2] + int(total))

    @property
    def _fitc_clamp_stats(self):
        acc = self._fitc_clamp_accum
        if acc is None:
            return None
        count, worst, total = int(acc[0]), float(acc[1]), int(acc[2])
        return dict(n_clamped=count, total=total,
                    frac=count / total if total else 0.0, worst=worst)

    def _latent_predict(self, aux, x0s):
        if self._z is not None:
            from . import sparse
            ghat, gvar = sparse.predict_fitc_core(
                self._free, self._data, aux, self._z, x0s,
                compute_dtype=self._compute_dtype, kernel=self.kernel)
            # stats over the user's columns only — batched predict pads the
            # final chunk with duplicated rows that must not be counted
            pad = getattr(self, '_predict_pad_cols', 0)
            stats_src = gvar[:, :gvar.shape[-1] - pad] if pad else gvar
            _, count, worst = sparse.clamp_variance(stats_src)
            gvar = jnp.maximum(gvar, 0.0)
            self._record_clamp_stats(count, worst, stats_src.size)
            return ghat, gvar
        if self._n_mesh is not None:
            from ..parallel import nshard
            return nshard.predict_nsharded_core(
                self._free, self._data, aux, x0s, self._n_mesh,
                compute_dtype=self._compute_dtype, jitter=self._jitter,
                kernel=self.kernel)
        core = (pred.predict_rep_core if self.submethod == 'rep'
                else pred.predict_full_core)
        return core(self._free, self._data, aux, x0s,
                    compute_dtype=self._compute_dtype, jitter=self._jitter,
                    kernel=self.kernel, q_chunk=self.q_chunk)

    def predict_full(self, x0, return_fullcov: bool = False):
        aux = self._ensure_aux()
        if not self._in_batched_predict:
            self._fitc_clamp_accum = None
        x0s = self._standardize_x0(x0)
        ghat, gvar = self._latent_predict(aux, x0s)
        self.ghat, self.gvar = ghat, gvar
        ypred, ypredvar, yconfvar = pred.recombine_full(
            self._free, self._data, ghat, gvar, self.ymean, self.ystd)
        if return_fullcov:
            yfullpredcov = pred.fullcov_full(self._free, self._data, gvar,
                                             self.ystd)
            return ypred, ypredvar, yconfvar, yfullpredcov
        return ypred, ypredvar, yconfvar

    def predict_rep(self, x0, return_fullcov: bool = False):
        aux = self._ensure_aux()
        if not self._in_batched_predict:
            self._fitc_clamp_accum = None
        x0s = self._standardize_x0(x0)
        ghat, gvar = self._latent_predict(aux, x0s)
        self.ghat, self.gvar = ghat, gvar
        if self.rep_standardize_ybar:
            mean, std = self.ybar_mean, self.ybar_std
        else:
            mean = jnp.zeros_like(self.ybar_mean)
            std = jnp.ones_like(self.ybar_std)
        ypred, ypredvar, yconfvar = pred.recombine_rep(
            self._free, self._data, ghat, gvar, mean, std)
        if return_fullcov:
            # full predictive covariance is full-path-only (lcgp.py:928-929)
            return ypred, ypredvar, yconfvar, None
        return ypred, ypredvar, yconfvar

    # ------------------------------------------------------------------
    # Persistence (new; SURVEY §5 "Checkpoint/resume: absent" in reference)
    # ------------------------------------------------------------------
    def save(self, path):
        lLmb, lLmb0, lsig_g, lnug = P.constrain(self._free)
        cfg = dict(q=int(self.q), var_threshold=self.var_threshold,
                   diag_error_structure=list(self.diag_error_structure),
                   parameter_clamp_flag=self.parameter_clamp_flag,
                   robust_mean=self.robust_mean, submethod=self.submethod,
                   rep_standardize_ybar=self.rep_standardize_ybar,
                   precision=self.precision, kernel=self.kernel,
                   q_chunk=self.q_chunk, n_chunk=self._n_chunk_arg)
        extra = {}
        if self._z is not None:
            extra['inducing_z_std'] = np.asarray(self._z)
        np.savez(path,
                 config=json.dumps(cfg),
                 x_orig=np.asarray(self.x_orig),
                 y_orig=np.asarray(self.y_orig),
                 **extra,
                 # free (unconstrained) values are the source of truth so the
                 # roundtrip is exact; constrained values stored for inspection
                 free_lLmb=np.asarray(self._free.lLmb),
                 free_lLmb0=np.asarray(self._free.lLmb0),
                 free_lsigma2s=np.asarray(self._free.lsigma2s),
                 free_lnugGPs=np.asarray(self._free.lnugGPs),
                 lLmb=np.asarray(lLmb), lLmb0=np.asarray(lLmb0),
                 lsigma2s=np.asarray(lsig_g), lnugGPs=np.asarray(lnug))

    @classmethod
    def load(cls, path):
        z = np.load(path, allow_pickle=False)
        cfg = json.loads(str(z['config']))
        model = cls(y=z['y_orig'], x=z['x_orig'],
                    q=cfg['q'], var_threshold=None,
                    diag_error_structure=cfg['diag_error_structure'],
                    parameter_clamp_flag=cfg['parameter_clamp_flag'],
                    robust_mean=cfg['robust_mean'], submethod=cfg['submethod'],
                    rep_standardize_ybar=cfg['rep_standardize_ybar'],
                    precision=cfg.get('precision', 'high'),
                    kernel=cfg.get('kernel', 'matern32'),
                    q_chunk=cfg.get('q_chunk'))
        model._free = P.FreeParams(jnp.asarray(z['free_lLmb']),
                                   jnp.asarray(z['free_lLmb0']),
                                   jnp.asarray(z['free_lsigma2s']),
                                   jnp.asarray(z['free_lnugGPs']))
        if 'inducing_z_std' in z:
            model._z = jnp.asarray(z['inducing_z_std'])
            # the ctor resolved n_chunk with _z unset; redo now that the
            # inducing set (and so the (q, n, m) panel size) is known
            model._n_chunk_arg = cfg.get('n_chunk')
            if model._n_chunk_arg is None:
                model.n_chunk = model._auto_n_chunk(
                    int(model.q), int(model.n), int(model._z.shape[0]),
                    model.precision)
            elif model._n_chunk_arg > 0:
                model.n_chunk = int(model._n_chunk_arg)
        model._params_version += 1
        return model
