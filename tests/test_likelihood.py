"""Cross-implementation parity: production (Cholesky, q-batched) vs the
NumPy oracle that follows the reference's own computational path (eigh /
explicit solves).  This is the SURVEY §4 'cross-implementation oracle'."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from lcgp_tpu.models import likelihood as lik
from lcgp_tpu.models import params as P
from lcgp_tpu.models import basis as basis_mod
import oracle

# pre-commit smoke set: oracle-parity + model-API (pytest -m quick, <3 min)
pytestmark = pytest.mark.quick


def _full_setup(seed=0, n=30, d=2, p=4, q=None, err=None):
    rng = np.random.default_rng(seed)
    xs = rng.uniform(0, 1, (n, d))
    ys = rng.standard_normal((p, n))
    ys = (ys - ys.mean(1, keepdims=True)) / ys.std(1, keepdims=True)
    b = basis_mod.init_phi(ys, q=q)
    err = err or [1] * p
    data = lik.FullData(xs=jnp.asarray(xs), ys=jnp.asarray(ys),
                        phi=jnp.asarray(b.phi), diag_D=jnp.asarray(b.diag_D),
                        sigma_map=jnp.asarray(P.sigma_index_map(err)))
    lLmb = rng.uniform(0.3, 2.0, (b.q, d))
    lLmb0 = rng.uniform(0.5, 2.0, b.q)
    lsig = rng.uniform(-3, -1, len(err))
    lnug = rng.uniform(1e-5, 1e-3, b.q)
    free = P.unconstrain(jnp.asarray(lLmb), jnp.asarray(lLmb0),
                         jnp.asarray(lsig), jnp.asarray(lnug))
    return data, free, (lLmb, lLmb0, lsig, lnug), b, xs, ys, err


def _rep_setup(seed=0, n=18, d=1, p=3, reps=3, use_std=True, err=None):
    rng = np.random.default_rng(seed)
    xu = rng.uniform(0, 1, (n, d))
    ybar = rng.standard_normal((p, n))
    r = rng.integers(1, reps + 1, n).astype(np.float64)
    ybar_mean = np.median(ybar, axis=1, keepdims=True)
    ybar_std = np.median(np.abs(ybar - ybar_mean), axis=1, keepdims=True)
    ybar_s = (ybar - ybar_mean) / ybar_std

    y_used = ybar_s if use_std else ybar
    scale = ybar_std[:, 0] if use_std else np.ones(p)
    b = basis_mod.init_phi(y_used)
    err = err or [1] * p
    data = lik.RepData(xs=jnp.asarray(xu), ybar=jnp.asarray(y_used),
                       scale=jnp.asarray(scale), r=jnp.asarray(r),
                       phi=jnp.asarray(b.phi), diag_D=jnp.asarray(b.diag_D),
                       sigma_map=jnp.asarray(P.sigma_index_map(err)))
    lLmb = rng.uniform(0.3, 2.0, (b.q, d))
    lLmb0 = rng.uniform(0.5, 2.0, b.q)
    lsig = rng.uniform(-3, -1, len(err))
    lnug = rng.uniform(1e-5, 1e-3, b.q)
    free = P.unconstrain(jnp.asarray(lLmb), jnp.asarray(lLmb0),
                         jnp.asarray(lsig), jnp.asarray(lnug))
    return (data, free, (lLmb, lLmb0, lsig, lnug), b, xu, y_used, scale, r,
            ybar_mean, ybar_std, err)


class TestFullLoss:
    @pytest.mark.parametrize('seed,n,d,p,q,err', [
        (0, 30, 2, 4, None, None),
        (1, 25, 1, 3, 2, None),
        (2, 40, 3, 5, 3, [2, 2, 1]),
        (3, 17, 5, 2, None, [1, 1]),
    ])
    def test_matches_oracle(self, seed, n, d, p, q, err):
        data, free, (lLmb, lLmb0, lsig, lnug), b, xs, ys, err = _full_setup(
            seed, n, d, p, q, err)
        ours = float(lik.neglpost_full(free, data))
        ref = oracle.neglpost_full_np(lLmb, lLmb0, lsig, lnug, xs, ys,
                                      b.phi, b.diag_D, err)
        np.testing.assert_allclose(ours, ref, rtol=1e-9)

    def test_grad_matches_finite_difference(self):
        data, free, *_ = _full_setup(5, 20, 2, 3)
        from jax.flatten_util import ravel_pytree
        flat, unravel = ravel_pytree(free)
        f = lambda z: lik.neglpost_full(unravel(z), data)
        g = jax.grad(f)(flat)
        eps = 1e-6
        for i in range(0, flat.shape[0], 3):
            e = jnp.zeros_like(flat).at[i].set(eps)
            fd = (f(flat + e) - f(flat - e)) / (2 * eps)
            np.testing.assert_allclose(float(g[i]), float(fd), rtol=2e-4,
                                       atol=1e-7)


class TestRepLoss:
    @pytest.mark.parametrize('seed,use_std,err', [
        (0, True, None),
        (1, False, None),
        (2, True, [2, 1]),
    ])
    def test_matches_oracle(self, seed, use_std, err):
        (data, free, (lLmb, lLmb0, lsig, lnug), b, xu, y_used, scale, r,
         _, _, err) = _rep_setup(seed, use_std=use_std, err=err)
        ours = float(lik.neglpost_rep(free, data))
        ref = oracle.neglpost_rep_np(lLmb, lLmb0, lsig, lnug, xu, y_used,
                                     scale, r, b.phi, b.diag_D, err)
        np.testing.assert_allclose(ours, ref, rtol=1e-9)

    def test_grad_finite(self):
        data, free, *_ = _rep_setup(3)
        g = jax.grad(lambda fr: lik.neglpost_rep(fr, data))(free)
        for leaf in jax.tree_util.tree_leaves(g):
            assert np.isfinite(np.asarray(leaf)).all()

    def test_jit_stability_across_calls(self):
        data, free, *_ = _rep_setup(4)
        v1 = float(lik.neglpost_rep(free, data))
        v2 = float(lik.neglpost_rep(free, data))
        assert v1 == v2


class TestQChunk:
    """q_chunk (memory-bounded lax.map + remat) must not change values or
    gradients."""

    def test_full_chunked_matches(self):
        data, free, *_ = _full_setup(0, 30, 2, 4)  # q = 4
        ref = float(lik.neglpost_full(free, data))
        for qc in (1, 2, 4):
            np.testing.assert_allclose(
                float(lik.neglpost_full(free, data, q_chunk=qc)), ref,
                rtol=1e-12)
        g_ref = jax.grad(lambda fr: lik.neglpost_full(fr, data))(free)
        g_chk = jax.grad(lambda fr: lik.neglpost_full(fr, data, q_chunk=2))(free)
        for a, b in zip(jax.tree_util.tree_leaves(g_chk),
                        jax.tree_util.tree_leaves(g_ref)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=1e-10, atol=1e-12)

    def test_rep_chunked_matches(self):
        data, free, *_ = _rep_setup(0, p=3)  # q = 3
        ref = float(lik.neglpost_rep(free, data))
        np.testing.assert_allclose(
            float(lik.neglpost_rep(free, data, q_chunk=1)), ref, rtol=1e-12)
        np.testing.assert_allclose(
            float(lik.neglpost_rep(free, data, q_chunk=3)), ref, rtol=1e-12)

    def test_invalid_chunk_raises(self):
        data, free, *_ = _full_setup(0, 20, 2, 4)
        import pytest
        with pytest.raises(ValueError):
            lik.neglpost_full(free, data, q_chunk=3)


class TestCustomVJP:
    """The hand-derived loss-term VJPs must match plain autodiff of the
    same forward computation."""

    @pytest.mark.parametrize('kernel', ['matern32', 'rbf'])
    def test_full_terms(self, kernel):
        data, free, *_ = _full_setup(11, 24, 2, 3)
        lLmb, lLmb0, lsig, lnug = P.constrain(free)
        a = (data.ys.T @ (data.phi /
                          jnp.sqrt(jnp.exp(lsig))[:, None])).T

        def f_custom(args):
            l, l0, nu, aa = args
            return jnp.sum(lik._full_terms(None, 0.0, kernel, data.xs,
                                           l, l0, nu, data.diag_D, aa) ** 2)

        def f_auto(args):
            l, l0, nu, aa = args
            t, _ = lik._full_terms_fwd_impl(None, 0.0, kernel, data.xs,
                                            l, l0, nu, data.diag_D, aa)
            return jnp.sum(t ** 2)

        args = (lLmb, lLmb0, lnug, a)
        np.testing.assert_allclose(float(f_custom(args)), float(f_auto(args)),
                                   rtol=1e-12)
        gc = jax.grad(f_custom)(args)
        ga = jax.grad(f_auto)(args)
        for c, aa in zip(gc, ga):
            np.testing.assert_allclose(np.asarray(c), np.asarray(aa),
                                       rtol=1e-7, atol=1e-10)

    @pytest.mark.parametrize('kernel', ['matern32', 'rbf'])
    def test_rep_terms(self, kernel):
        data, free, *_ = _rep_setup(12, n=15, p=3)
        lLmb, lLmb0, lsig, lnug = P.constrain(free)
        sis = data.scale / jnp.sqrt(jnp.exp(lsig))
        b = data.r[None, :] * (data.ybar.T @ (data.phi * sis[:, None])).T
        sr = jnp.sqrt(data.r)

        def f_custom(args):
            l, l0, nu, bb = args
            return jnp.sum(lik._rep_terms(None, 0.0, kernel, data.xs, sr,
                                          l, l0, nu, data.diag_D, bb) ** 2)

        def f_auto(args):
            l, l0, nu, bb = args
            t, _ = lik._rep_terms_fwd_impl(None, 0.0, kernel, data.xs, sr,
                                           l, l0, nu, data.diag_D, bb)
            return jnp.sum(t ** 2)

        args = (lLmb, lLmb0, lnug, b)
        np.testing.assert_allclose(float(f_custom(args)), float(f_auto(args)),
                                   rtol=1e-12)
        gc = jax.grad(f_custom)(args)
        ga = jax.grad(f_auto)(args)
        for c, aa in zip(gc, ga):
            np.testing.assert_allclose(np.asarray(c), np.asarray(aa),
                                       rtol=1e-7, atol=1e-10)


class TestBlockedTriInverse:
    def test_blocked_path_matches_xla(self):
        """n=1024 f64 triggers the blocked algorithm; values must agree
        with the plain triangular solve to fp accumulation tolerance."""
        import jax.numpy as jnp
        from jax import lax
        from lcgp_tpu.ops import linalg
        rng = np.random.default_rng(0)
        n = 1024
        A = rng.standard_normal((2, n, 32))
        B = jnp.asarray(A @ np.swapaxes(A, -1, -2) + 5.0 * np.eye(n))
        L = jnp.linalg.cholesky(B)
        Xb = np.asarray(linalg.tri_inverse_lower(L))
        eye = jnp.broadcast_to(jnp.eye(n, dtype=L.dtype), L.shape)
        Xr = np.asarray(lax.linalg.triangular_solve(
            L, eye, left_side=True, lower=True))
        np.testing.assert_allclose(Xb, Xr, rtol=1e-9, atol=1e-11)

    def test_small_and_odd_sizes_fall_back(self):
        import jax.numpy as jnp
        from lcgp_tpu.ops import linalg
        rng = np.random.default_rng(1)
        for n in (40, 700):
            A = rng.standard_normal((1, n, 16))
            B = jnp.asarray(A @ np.swapaxes(A, -1, -2) + 3.0 * np.eye(n))
            L = jnp.linalg.cholesky(B)
            Binv = np.asarray(linalg.chol_inverse(L))
            np.testing.assert_allclose(Binv, np.linalg.inv(np.asarray(B)),
                                       rtol=1e-8, atol=1e-10)


class TestBlockedCholesky:
    @pytest.mark.quick
    def test_blocked_matches_xla(self):
        """n >= 2 blocks triggers the blocked right-looking factorization;
        values must equal jnp.linalg.cholesky to factorization roundoff,
        including the identity-tail padding for non-divisible n."""
        import jax.numpy as jnp
        from lcgp_tpu.ops import linalg
        rng = np.random.default_rng(3)
        for n in (1024, 1100, 1536):
            M = rng.standard_normal((2, n, 16))
            A = jnp.asarray(M @ np.swapaxes(M, -1, -2) / 16
                            + 2.0 * np.eye(n))
            L_ref = np.asarray(jnp.linalg.cholesky(A))
            L = np.asarray(linalg.cholesky(A))
            np.testing.assert_allclose(L, L_ref, rtol=1e-10, atol=1e-12)
            assert np.allclose(np.triu(L, 1), 0.0)

    @pytest.mark.quick
    def test_small_falls_back(self):
        import jax.numpy as jnp
        from lcgp_tpu.ops import linalg
        rng = np.random.default_rng(4)
        n = 96
        M = rng.standard_normal((3, n, 8))
        A = jnp.asarray(M @ np.swapaxes(M, -1, -2) / 8 + np.eye(n))
        np.testing.assert_allclose(np.asarray(linalg.cholesky(A)),
                                   np.asarray(jnp.linalg.cholesky(A)),
                                   rtol=1e-12, atol=1e-14)

    def test_not_psd_propagates_nan(self):
        """Indefinite input must surface as NaN (the fit drivers map
        non-finite losses to +inf), not silently produce garbage."""
        import jax.numpy as jnp
        from lcgp_tpu.ops import linalg
        n = 1024
        A = jnp.asarray(-np.eye(n))[None]
        L = np.asarray(linalg.cholesky(A))
        assert np.isnan(L).any()


class TestStructuredTriProducts:
    """syrk_tri_lower / gram_tri_lower: the triangular-blocked strip GEMMs
    (n^3/3 flops) must match the dense products exactly up to accumulation
    order, on the blocked path, the fallback path, and in f32."""

    def test_syrk_matches_dense(self):
        import jax.numpy as jnp
        from lcgp_tpu.ops import linalg
        rng = np.random.default_rng(2)
        for shape, n in (((3,), 1024), ((), 1536), ((2,), 700)):
            L = jnp.asarray(np.tril(rng.standard_normal(shape + (n, n)))
                            + 2.0 * np.eye(n))
            ref = np.asarray(L @ jnp.swapaxes(L, -1, -2))
            got = np.asarray(linalg.syrk_tri_lower(L))
            np.testing.assert_allclose(got, ref, rtol=1e-13, atol=1e-12)

    def test_gram_matches_dense(self):
        import jax.numpy as jnp
        from lcgp_tpu.ops import linalg
        rng = np.random.default_rng(3)
        for shape, n in (((3,), 1024), ((), 1536), ((2,), 700)):
            M = jnp.asarray(np.tril(rng.standard_normal(shape + (n, n)))
                            + np.eye(n))
            ref = np.asarray(jnp.swapaxes(M, -1, -2) @ M)
            got = np.asarray(linalg.gram_tri_lower(M))
            np.testing.assert_allclose(got, ref, rtol=1e-13, atol=1e-12)

    def test_f32_blocked(self):
        import jax.numpy as jnp
        from lcgp_tpu.ops import linalg
        rng = np.random.default_rng(4)
        n = 1024
        L = jnp.asarray(np.tril(rng.standard_normal((n, n)))
                        + 30.0 * np.eye(n), dtype=jnp.float32)
        ref = np.asarray(L @ L.T)
        got = np.asarray(linalg.syrk_tri_lower(L))
        np.testing.assert_allclose(got, ref, rtol=2e-6, atol=2e-5)

    def test_trmm_and_lower_products(self):
        """trmm_lower / mul_t_block_lower / mul_lower_lower (the mixed
        correction's structured f32 GEMMs) match the dense products on
        blocked and fallback sizes; mul_t_block_lower only guarantees the
        lower triangle (that is all the projector reads)."""
        import jax.numpy as jnp
        from lcgp_tpu.ops import linalg
        rng = np.random.default_rng(6)
        for n in (1024, 700):
            L = jnp.asarray(np.tril(rng.standard_normal((2, n, n)))
                            + 2.0 * np.eye(n))
            X = jnp.asarray(rng.standard_normal((2, n, n)))
            np.testing.assert_allclose(
                np.asarray(linalg.trmm_lower(L, X)), np.asarray(L @ X),
                rtol=1e-12, atol=1e-11)
            got = linalg.mul_t_block_lower(X, L)
            full = X @ jnp.swapaxes(L, -1, -2)
            np.testing.assert_allclose(
                np.asarray(jnp.tril(got)), np.asarray(jnp.tril(full)),
                rtol=1e-12, atol=1e-11)
            P = jnp.asarray(np.tril(rng.standard_normal((2, n, n))))
            np.testing.assert_allclose(
                np.asarray(linalg.mul_lower_lower(L, P)), np.asarray(L @ P),
                rtol=1e-12, atol=1e-11)

    def test_padded_non_divisible_sizes(self):
        """n not a multiple of the 512 block (and >= 2 blocks) takes the
        zero-padded blocked path, not the dense fallback — all five ops
        must still match dense exactly, and gradients must flow through
        the pad/slice."""
        import jax
        import jax.numpy as jnp
        from lcgp_tpu.ops import linalg
        rng = np.random.default_rng(7)
        n = 1200
        L = jnp.asarray(np.tril(rng.standard_normal((2, n, n)))
                        + 2.0 * np.eye(n))
        M = jnp.asarray(np.tril(rng.standard_normal((n, n))) + np.eye(n))
        X = jnp.asarray(rng.standard_normal((n, 64)))
        Y = jnp.asarray(rng.standard_normal((n, n)))
        np.testing.assert_allclose(
            np.asarray(linalg.syrk_tri_lower(L)),
            np.asarray(L @ jnp.swapaxes(L, -1, -2)), rtol=1e-12, atol=1e-10)
        np.testing.assert_allclose(
            np.asarray(linalg.gram_tri_lower(M)), np.asarray(M.T @ M),
            rtol=1e-12, atol=1e-10)
        np.testing.assert_allclose(
            np.asarray(linalg.trmm_lower(M, X)), np.asarray(M @ X),
            rtol=1e-12, atol=1e-10)
        got = linalg.mul_t_block_lower(Y, M)
        np.testing.assert_allclose(
            np.asarray(jnp.tril(got)), np.asarray(jnp.tril(Y @ M.T)),
            rtol=1e-12, atol=1e-10)
        P = jnp.asarray(np.tril(rng.standard_normal((n, n))))
        np.testing.assert_allclose(
            np.asarray(linalg.mul_lower_lower(M, P)), np.asarray(M @ P),
            rtol=1e-12, atol=1e-10)
        g = jax.grad(
            lambda a: jnp.sum(linalg.syrk_tri_lower(jnp.tril(a))))(L[0])
        assert bool(jnp.all(jnp.isfinite(g)))

    def test_mixed_refinement_uses_structured_residual(self):
        """cholesky_mixed at a blocked size still reaches the f64 floor —
        the structured residual is exact, not approximate."""
        import jax.numpy as jnp
        from lcgp_tpu.ops import linalg, mixed as mixed_ops
        rng = np.random.default_rng(5)
        n = 1024
        A = rng.standard_normal((n, 48))
        B = jnp.asarray(A @ A.T + 50.0 * np.eye(n))
        L = mixed_ops.cholesky_mixed(B, refine_steps=2)
        ld_ref = float(linalg.chol_logdet(jnp.linalg.cholesky(B)))
        ld_mx = float(linalg.chol_logdet(L))
        np.testing.assert_allclose(ld_mx, ld_ref, rtol=1e-10)


class TestMixedPrecision:
    """precision='mixed': f32 factor + f64-GEMM refinement must reproduce
    the f64 path to ~1e-8 (VERDICT target: oracle rtol 1e-6)."""

    def test_full_loss_matches_high(self):
        data, free = _full_setup(seed=11, n=60, p=6, q=3)[:2]
        hi = float(lik.neglpost_full(free, data))
        mx = float(lik.neglpost_full(free, data, compute_dtype='mixed'))
        np.testing.assert_allclose(mx, hi, rtol=1e-8)

    def test_rep_loss_matches_high(self):
        data, free = _rep_setup(seed=12)[:2]
        hi = float(lik.neglpost_rep(free, data))
        mx = float(lik.neglpost_rep(free, data, compute_dtype='mixed'))
        np.testing.assert_allclose(mx, hi, rtol=1e-8)

    def test_full_grad_matches_high(self):
        import jax
        data, free = _full_setup(seed=13, n=50, p=5, q=2)[:2]
        g_hi = jax.grad(lambda fr: lik.neglpost_full(fr, data))(free)
        g_mx = jax.grad(lambda fr: lik.neglpost_full(
            fr, data, compute_dtype='mixed'))(free)
        # mixed gradients are f32-grade by design (round 3; the loss
        # stays f64-grade — see likelihood._factor_inverse)
        for a, b in zip(jax.tree.leaves(g_hi), jax.tree.leaves(g_mx)):
            np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                       rtol=5e-4, atol=1e-7)

    def test_model_level_mixed(self):
        from lcgp_tpu import LCGP, datasets
        xtr, ytr, xte, _ = datasets.make_rep_data_skewed(seed=14)
        hi = LCGP(y=ytr, x=xtr, q=3, submethod='rep', precision='high')
        mx = LCGP(y=ytr, x=xtr, q=3, submethod='rep', precision='mixed')
        np.testing.assert_allclose(float(mx.loss()), float(hi.loss()),
                                   rtol=1e-8)
        yp_hi = np.asarray(hi.predict(xte)[0])
        yp_mx = np.asarray(mx.predict(xte)[0])
        np.testing.assert_allclose(yp_mx, yp_hi, rtol=1e-6, atol=1e-9)


class TestMixedBackwardAndEscalation:
    def test_parse_refine_sentinels(self):
        from lcgp_tpu.ops import mixed as mixed_ops
        assert mixed_ops.parse_refine('mixed') == 2
        assert mixed_ops.parse_refine('mixed:4') == 4
        assert mixed_ops.parse_refine(None) is None
        assert mixed_ops.parse_refine(jnp.float32) is None
        assert mixed_ops.is_mixed('mixed:3')

    def test_mixed_gradient_f32_grade(self):
        """'mixed' = f64-grade loss + f32-grade gradients (design point:
        an f64-grade backward inverse costs more than it saves — see
        likelihood._factor_inverse)."""
        data, free, *_ = _full_setup(21, 48, 2, 4)
        g64 = jax.grad(lambda fr: lik.neglpost_full(fr, data))(free)
        gmx = jax.grad(lambda fr: lik.neglpost_full(
            fr, data, compute_dtype='mixed'))(free)
        for a, b in zip(jax.tree.leaves(gmx), jax.tree.leaves(g64)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=5e-4, atol=1e-7)

    def test_mixed_gradient_bounded_at_high_conditioning(self):
        """The f32-grade mixed gradient must stay within ~1% of f64 even
        at amplitudes near the SoftClip ceiling (the escalation path
        tightens the forward/loss, which carries the 1e-8 criterion —
        benchmarks/validate_mixed.py checks it at the headline configs)."""
        import jax.numpy as jnp
        from lcgp_tpu.models import params as Pm
        data, free, *_ = _full_setup(21, 48, 2, 4)
        lLmb, lLmb0, lsig, lnug = Pm.constrain(free)
        free = Pm.unconstrain(lLmb, jnp.full_like(lLmb0, 5e3), lsig, lnug)
        g64 = jax.grad(lambda fr: lik.neglpost_full(fr, data))(free)
        gmx = jax.grad(lambda fr: lik.neglpost_full(
            fr, data, compute_dtype='mixed'))(free)
        rel = max(float(np.max(
            np.abs(np.asarray(a) - np.asarray(b))
            / np.maximum(1e-7, np.abs(np.asarray(b)))))
            for a, b in zip(jax.tree.leaves(gmx), jax.tree.leaves(g64)))
        assert rel < 1e-2, rel
        # and the loss stays at the f64 floor
        ref = float(lik.neglpost_full(free, data))
        mx = float(lik.neglpost_full(free, data, compute_dtype='mixed'))
        assert abs(mx - ref) / abs(ref) < 1e-9

    def test_mixed_rep_gradient_f32_grade(self):
        data, free, *_ = _rep_setup(22, 40, 2, 4)
        g64 = jax.grad(lambda fr: lik.neglpost_rep(fr, data))(free)
        gmx = jax.grad(lambda fr: lik.neglpost_rep(
            fr, data, compute_dtype='mixed'))(free)
        for a, b in zip(jax.tree.leaves(gmx), jax.tree.leaves(g64)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=5e-4, atol=1e-7)

    def test_escalated_steps_loss_matches(self):
        data, free, *_ = _full_setup(23, 32, 2, 4)
        ref = float(lik.neglpost_full(free, data))
        for cd in ('mixed', 'mixed:3', 'mixed:4'):
            got = float(lik.neglpost_full(free, data, compute_dtype=cd))
            np.testing.assert_allclose(got, ref, rtol=1e-9)

    def test_chol_inverse_from_factor(self):
        from lcgp_tpu.ops import linalg, mixed as mixed_ops
        rng = np.random.default_rng(24)
        A = rng.standard_normal((3, 24, 8))
        B = jnp.asarray(A @ np.swapaxes(A, -1, -2) + 4.0 * np.eye(24))
        L = linalg.cholesky(B)
        X = mixed_ops.chol_inverse_from_factor_mixed(L, newton_steps=2)
        np.testing.assert_allclose(np.asarray(X),
                                   np.linalg.inv(np.asarray(B)),
                                   rtol=1e-9, atol=1e-11)

    def test_model_recommends_and_escalates(self):
        from lcgp_tpu import LCGP, datasets
        xtr, ytr, _, _ = datasets.make_rep_data_skewed(seed=25)
        m = LCGP(y=ytr, x=xtr, q=3, submethod='rep', precision='mixed')
        k = m.recommended_refine_steps()
        assert 2 <= k <= 5
        # forcing a huge amplitude must raise the recommendation
        m.set_params(lLmb0=np.full(3, 5e3))   # inside the SoftClip bound
        assert m.recommended_refine_steps() > k

    def test_health_check_reports_refine_steps(self):
        from lcgp_tpu import LCGP, datasets
        from lcgp_tpu.utils.diagnostics import health_check
        xtr, ytr, _, _ = datasets.make_rep_data_skewed(seed=26)
        m = LCGP(y=ytr, x=xtr, q=3, submethod='rep', precision='mixed')
        m.fit(method='adam', steps=20)
        rep = health_check(m)
        fc = rep['checks']['factor_conditioning']
        assert 'refine_steps_recommended' in fc
        assert 2 <= fc['refine_steps_recommended'] <= 5
