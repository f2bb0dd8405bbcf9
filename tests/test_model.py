"""Model-shell behavior: constructor validation, attribute contracts,
training/prediction flows — ported from the reference's test strategy
(SURVEY §4: tests/test_initialize.py, test_training.py, test_rep.py,
test_coverage_gaps.py)."""
import copy

import jax
import numpy as np
import pytest

from lcgp_tpu import LCGP, evaluation

# pre-commit smoke set: oracle-parity + model-API (pytest -m quick, <3 min)
pytestmark = pytest.mark.quick


def _make_full_data(seed=0, n=50, p=4, d=2):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (n, d))
    y = rng.standard_normal((p, n))
    return x, y


def _make_rep_data(seed=0, n_unique=20, p=4, d=2, reps=3):
    rng = np.random.default_rng(seed)
    x_unique = rng.uniform(0, 1, (n_unique, d))
    x = np.tile(x_unique, (reps, 1))
    y = rng.standard_normal((p, n_unique * reps))
    return x, y, x_unique, n_unique


class TestInit:
    def test_simplest_1d_fail(self):
        x = np.linspace(0, 1, 40)
        y = copy.copy(x)
        with pytest.raises(AssertionError):
            LCGP(y=y, x=x)

    def test_simplest_1d_pass(self):
        x = np.linspace(0, 1, 40)
        y = np.reshape(copy.copy(x), (1, 40))
        LCGP(y=y, x=x)

    def test_simplest_hd(self):
        x, y = _make_full_data(n=40, p=3, d=5)
        LCGP(y=y, x=x)

    def test_print_model(self):
        x, y = _make_full_data(n=40, p=3, d=5)
        model = LCGP(y=y, x=x)
        s = repr(model)
        assert 'LCGP' in s and 'full' in s and 'latent components' in s

    @pytest.mark.parametrize('err_struct', [[2, 1], [1, 1, 1], None, [1, 2]])
    def test_err_struct(self, err_struct):
        x, y = _make_full_data(n=40, p=3)
        LCGP(y=y, x=x, diag_error_structure=err_struct)

    @pytest.mark.parametrize('err_struct', [[1, 1], [0, 1, 1], [2, 2]])
    def test_invalid_err_struct(self, err_struct):
        x, y = _make_full_data(n=40, p=3)
        with pytest.raises(AssertionError):
            LCGP(y=y, x=x, diag_error_structure=err_struct)

    @pytest.mark.parametrize('robust_mean', [True, False])
    def test_robust(self, robust_mean):
        x = np.linspace(0, 1, 40)
        y = np.reshape(copy.copy(x), (1, 40))
        LCGP(y=y, x=x, robust_mean=robust_mean)

    def test_invalid_q_varthreshold(self):
        x, y = _make_full_data(n=40, p=3)
        with pytest.raises(ValueError):
            LCGP(y=y, x=x, q=2, var_threshold=0.9)

    def test_varthreshold(self):
        x, y = _make_full_data(n=40, p=3)
        m = LCGP(y=y, x=x, q=None, var_threshold=0.9)
        assert 1 <= m.q <= 3

    def test_mismatch_dimension(self):
        with pytest.raises(AssertionError):
            LCGP(y=np.random.randn(3, 25), x=np.linspace(0, 1, 40))

    def test_invalid_submethod(self):
        x, y = _make_full_data()
        with pytest.raises(ValueError):
            LCGP(y=y, x=x, submethod='bogus')

    def test_tx_xy_roundtrip(self):
        x, y = _make_full_data(n=40, p=2)
        model = LCGP(y=y, x=x)
        x_rec = np.asarray(model.tx_x(model.x))
        np.testing.assert_allclose(x_rec, x, atol=1e-10)
        y_rec = np.asarray(model.tx_y(model.y))
        np.testing.assert_allclose(y_rec, y, atol=1e-10)

    def test_param_shapes(self):
        x, y = _make_full_data(n=30, p=3)
        m = LCGP(y=y, x=x, q=2, diag_error_structure=[2, 1])
        lLmb, lLmb0, lsig, lnug = m.get_param()
        assert lLmb.shape == (2, 2)
        assert lLmb0.shape == (2,)
        assert lsig.shape == (3,)       # expanded to per-output
        assert lnug.shape == (2,)
        assert np.asarray(m.lsigma2s).shape == (2,)  # grouped


class TestTrainingFull:
    def test_fit_predict_smoke(self):
        rng = np.random.default_rng(1)
        x = rng.uniform(0, 1, (40, 1))
        f = np.vstack([np.sin(6 * x[:, 0]), np.cos(6 * x[:, 0])])
        y = f + rng.normal(0, 0.05, f.shape)
        m = LCGP(y=y, x=x)
        l0 = float(m.loss())
        m.fit(maxiter=50)
        assert float(m.loss()) < l0
        yp, ypv, ycv = m.predict(x)
        assert yp.shape == y.shape
        assert np.isfinite(np.asarray(yp)).all()
        assert (np.asarray(ypv) > 0).all()
        assert (np.asarray(ycv) <= np.asarray(ypv) + 1e-12).all()
        # beats predicting the mean
        base = evaluation.rmse(f, np.tile(y.mean(1, keepdims=True), (1, 40)))
        assert evaluation.rmse(f, np.asarray(yp)) < base

    def test_fullcov_diag_matches_predvar(self):
        x, y = _make_full_data(3, n=30, p=3)
        m = LCGP(y=y, x=x)
        yp, ypv, ycv, cov = m.predict(x[:6], return_fullcov=True)
        np.testing.assert_allclose(
            np.diagonal(np.asarray(cov), axis1=1, axis2=2).T,
            np.asarray(ypv), rtol=1e-5)

    def test_aux_refreshed_after_fit(self):
        """predict -> fit -> predict must use post-fit parameters
        (fixes reference stale-cache hazard, SURVEY §3.5.1)."""
        rng = np.random.default_rng(2)
        x = rng.uniform(0, 1, (30, 1))
        y = np.vstack([np.sin(6 * x[:, 0])]) + rng.normal(0, 0.1, (1, 30))
        m = LCGP(y=y, x=x)
        p0 = np.asarray(m.predict(x)[0])
        m.fit(maxiter=30)
        p1 = np.asarray(m.predict(x)[0])
        assert not np.allclose(p0, p1)


class TestTrainingRep:
    def test_rep_structures(self):
        x, y, x_unique, n_unique = _make_rep_data()
        m = LCGP(y=y, x=x, submethod='rep')
        assert m.n == n_unique
        assert np.asarray(m.r).sum() == x.shape[0]
        assert m.R.shape == (n_unique, n_unique)
        np.testing.assert_allclose(np.asarray(m.R),
                                   np.diag(np.asarray(m.r, dtype=float)))
        assert m.ybar.shape == (4, n_unique)
        assert m.ybar_s.shape == (4, n_unique)
        # x_unique rows all come from the original design
        xu = np.asarray(m.x_unique)
        for row in xu:
            assert (np.abs(x_unique - row).sum(axis=1) < 1e-12).any()

    def test_loss_decreases_and_params_finite(self):
        x, y, *_ = _make_rep_data(seed=5, n_unique=15, p=3, reps=2)
        m = LCGP(y=y, x=x, submethod='rep')
        l0 = float(m.loss())
        m.fit(maxiter=50)
        l1 = float(m.loss())
        assert l1 < l0
        for arr in m.get_param():
            assert np.isfinite(np.asarray(arr)).all()

    def test_predict_contract(self):
        x, y, *_ = _make_rep_data(seed=6, n_unique=12, p=3, reps=2)
        m = LCGP(y=y, x=x, submethod='rep')
        x0 = np.random.default_rng(0).uniform(0, 1, (8, 2))
        yp, ypv, ycv = m.predict(x0)
        assert yp.shape == (3, 8)
        assert (np.asarray(ypv) > 0).all()
        assert (np.asarray(ycv) <= np.asarray(ypv) + 1e-12).all()
        out = m.predict(x0, return_fullcov=True)
        assert len(out) == 4 and out[3] is None

    @pytest.mark.parametrize('use_std', [True, False])
    def test_rep_standardize_toggle(self, use_std):
        x, y, *_ = _make_rep_data(seed=7, n_unique=10, p=2, reps=2)
        m = LCGP(y=y, x=x, submethod='rep', rep_standardize_ybar=use_std)
        assert np.isfinite(float(m.loss()))
        yp = m.predict(x[:5])[0]
        assert np.isfinite(np.asarray(yp)).all()

    def test_preprocess_tuple_contract(self):
        x, y, x_unique, n_unique = _make_rep_data(seed=8)
        m = LCGP(y=y, x=x, submethod='rep')
        out = m.preprocess()
        assert len(out) == 12
        (xu, xus, gids, r, R, ybar, ybar_s, ybar_mean, ybar_std,
         n_u, d, p) = out
        assert n_u == n_unique and d == 2 and p == 4
        assert xu.shape == (n_unique, 2)
        np.testing.assert_allclose(np.asarray(R),
                                   np.diag(np.asarray(r, dtype=float)))


class TestPersistence:
    def test_save_load_roundtrip(self, tmp_path):
        x, y, *_ = _make_rep_data(seed=9, n_unique=10, p=2, reps=2)
        m = LCGP(y=y, x=x, submethod='rep')
        m.fit(maxiter=20)
        x0 = x[:7]
        p_before = np.asarray(m.predict(x0)[0])
        path = tmp_path / 'model.npz'
        m.save(path)
        m2 = LCGP.load(path)
        p_after = np.asarray(m2.predict(x0)[0])
        np.testing.assert_allclose(p_before, p_after, rtol=1e-12)

    def test_set_params_roundtrip(self):
        x, y = _make_full_data(10, n=25, p=2)
        m = LCGP(y=y, x=x)
        lLmb, lLmb0, _, lnug = m.get_param()
        m.set_params(lLmb=np.asarray(lLmb) * 2.0)
        np.testing.assert_allclose(np.asarray(m.lLmb), np.asarray(lLmb) * 2,
                                   rtol=1e-8)


class TestPredictBatching:
    def test_batched_matches_oneshot(self):
        rng = np.random.default_rng(21)
        x = rng.uniform(0, 1, (30, 2))
        y = rng.standard_normal((3, 30))
        m = LCGP(y=y, x=x)
        x0 = rng.uniform(0, 1, (23, 2))
        full = m.predict(x0)
        batched = m.predict(x0, batch_size=7)  # 23 = 3*7 + 2 -> padded tail
        for a, b in zip(full, batched):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=1e-12)

    def test_batched_rep(self):
        rng = np.random.default_rng(22)
        xu = rng.uniform(0, 1, (10, 1))
        x = np.tile(xu, (2, 1))
        y = rng.standard_normal((2, 20))
        m = LCGP(y=y, x=x, submethod='rep')
        x0 = rng.uniform(0, 1, (11, 1))
        full = m.predict(x0)
        batched = m.predict(x0, batch_size=4)
        for a, b in zip(full, batched):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=1e-12)

    def test_batch_with_fullcov_raises(self):
        rng = np.random.default_rng(23)
        x = rng.uniform(0, 1, (15, 1))
        y = rng.standard_normal((2, 15))
        m = LCGP(y=y, x=x)
        with pytest.raises(ValueError):
            m.predict(x, batch_size=4, return_fullcov=True)


class _FakeGPU:
    """Stands in for a CUDA device in the memory planner's probe."""
    platform = 'gpu'
    device_kind = 'Fake GPU'

    def __init__(self, bytes_limit):
        self._limit = bytes_limit

    def memory_stats(self):
        return {'bytes_limit': self._limit}


class TestAutoQChunk:
    def test_small_problem_unchunked(self):
        import numpy as np
        from lcgp_tpu import LCGP
        rng = np.random.default_rng(0)
        m = LCGP(y=rng.standard_normal((3, 30)), x=rng.uniform(0, 1, (30, 2)))
        assert m.q_chunk is None

    def test_headline_scale_matches_measured_feasible(self):
        from lcgp_tpu.models.lcgp import LCGP
        # the fixed 10 GB CPU budget under the (8*qc + q) n^2 peak model
        assert LCGP._auto_q_chunk(20, 4096, 'high') == 5
        assert LCGP._auto_q_chunk(20, 4096, 'fast') == 10
        assert LCGP._auto_q_chunk(20, 4096, 'mixed') == 5
        assert LCGP._auto_q_chunk(5, 1000, 'high') is None

    def test_explicit_override(self):
        import numpy as np
        from lcgp_tpu import LCGP
        rng = np.random.default_rng(1)
        y = rng.standard_normal((4, 24))
        x = rng.uniform(0, 1, (24, 1))
        m = LCGP(y=y, x=x, q=4, q_chunk=2)
        assert m.q_chunk == 2
        m0 = LCGP(y=y, x=x, q=4, q_chunk=0)   # force unchunked
        assert m0.q_chunk is None

    def test_env_budget_override(self, monkeypatch):
        """LCGP_TPU_HBM_BUDGET_BYTES rescales the auto-chunk decisions."""
        from lcgp_tpu.models.lcgp import LCGP
        monkeypatch.setenv('LCGP_TPU_HBM_BUDGET_BYTES', '20e9')
        assert LCGP._hbm_budget_bytes() == 20e9
        # 2x budget: f64 headline config fits qc=10 ((8*10+20)*n^2*8 = 13.4GB)
        assert LCGP._auto_q_chunk(20, 4096, 'high') == 10
        monkeypatch.setenv('LCGP_TPU_HBM_BUDGET_BYTES', '2e9')
        assert LCGP._auto_q_chunk(20, 4096, 'high') == 1

    def test_probed_memory_stats_budget(self, monkeypatch):
        """A GPU advertising a bytes_limit gets a proportional budget —
        auto-chunking adapts to the device's memory by construction."""
        from lcgp_tpu.models.lcgp import LCGP

        monkeypatch.delenv('LCGP_TPU_HBM_BUDGET_BYTES', raising=False)
        monkeypatch.setattr(jax, 'local_devices',
                            lambda: [_FakeGPU(31.5e9)])
        budget = LCGP._hbm_budget_bytes()
        assert budget == LCGP._HBM_BUDGET_FRACTION * 31.5e9   # = 20 GB
        assert LCGP._auto_q_chunk(20, 4096, 'high') == 10

    def test_gpu_bytes_limit_sizes_headline_unchunked(self, monkeypatch):
        """An 80 GB card under JAX's default 75% preallocation reports a
        ~60 GB bytes_limit; the headline f64 stack's modelled peak
        (8*20+20)*4096^2*8 = 24.2 GB fits, so the planner picks no
        chunking."""
        from lcgp_tpu.models.lcgp import LCGP

        monkeypatch.delenv('LCGP_TPU_HBM_BUDGET_BYTES', raising=False)
        monkeypatch.setattr(jax, 'local_devices',
                            lambda: [_FakeGPU(0.75 * 79.6e9)])
        assert LCGP._q_peak_bytes(20, 20, 4096, 'high') == \
            pytest.approx(24.16e9, rel=1e-3)
        assert LCGP._auto_q_chunk(20, 4096, 'high') is None
        assert LCGP._auto_q_chunk(20, 8192, 'high') == 5

    def test_gpu_bytes_limit_sizes_fitc_stream(self, monkeypatch):
        """FITC's (q, n, m) panel model against an 80 GB card: n=200,000
        (measured 33.2 GB compiled) stays un-chunked, n=400,000 streams."""
        from lcgp_tpu.models.lcgp import LCGP

        monkeypatch.delenv('LCGP_TPU_HBM_BUDGET_BYTES', raising=False)
        monkeypatch.setattr(jax, 'local_devices',
                            lambda: [_FakeGPU(0.75 * 79.6e9)])
        assert LCGP._fitc_peak_bytes(5, 200_000, 512, 'high') > 33.2e9
        assert LCGP._auto_n_chunk(5, 200_000, 512, 'high') is None
        assert LCGP._auto_n_chunk(5, 400_000, 512, 'high') == 8192

    @pytest.mark.parametrize('stats', [None, {}, {'bytes_limit': 0}])
    def test_accelerator_without_bytes_limit_raises(self, monkeypatch,
                                                     stats):
        """No reported memory limit on an accelerator is an error — never
        a guessed size that could OOM or chunk for nothing."""
        from lcgp_tpu.models.lcgp import LCGP

        dev = _FakeGPU(None)
        dev.memory_stats = lambda: stats
        monkeypatch.delenv('LCGP_TPU_HBM_BUDGET_BYTES', raising=False)
        monkeypatch.setattr(jax, 'local_devices', lambda: [dev])
        with pytest.raises(RuntimeError, match='bytes_limit'):
            LCGP._hbm_budget_bytes()
        # an explicit budget still lets the user proceed
        monkeypatch.setenv('LCGP_TPU_HBM_BUDGET_BYTES', '20e9')
        assert LCGP._auto_q_chunk(20, 4096, 'high') == 10

    def test_cpu_falls_back_to_default(self):
        """conftest forces CPU: the probe must return the calibrated
        default so test-suite chunk decisions stay deterministic."""
        from lcgp_tpu.models.lcgp import LCGP
        assert LCGP._hbm_budget_bytes() == LCGP._HBM_BUDGET_DEFAULT


class TestMixedRefineRatchet:
    def test_loss_ratchets_refine_steps(self):
        """Out-of-fit loss() on a mixed model must see conditioning-
        appropriate forward refinement (the validate_mixed copied-params
        pattern): steps ratchet up, never down."""
        import jax.numpy as jnp
        import numpy as np
        from lcgp_tpu import LCGP
        from lcgp_tpu.models import params as Pm
        rng = np.random.default_rng(7)
        y = rng.standard_normal((3, 128))
        x = rng.uniform(0, 1, (128, 2))
        m = LCGP(y=y, x=x, q=3, precision='mixed')
        assert m._compute_dtype == 'mixed'
        lLmb, lLmb0, lsig, lnug = Pm.constrain(m._free)
        m._free = Pm.unconstrain(lLmb, jnp.full_like(lLmb0, 9e3), lsig, lnug)
        m._params_version += 1
        assert m.recommended_refine_steps() > 2
        lo = float(m.loss())
        assert np.isfinite(lo)
        assert m._compute_dtype == f'mixed:{m.recommended_refine_steps()}'
        # and it never ratchets down
        m._free = Pm.unconstrain(lLmb, lLmb0, lsig, lnug)
        m._params_version += 1
        float(m.loss())
        assert m._compute_dtype != 'mixed'


class TestAutoPrecision:
    """precision='auto' policy: 'mixed' at n >= 2048, 'high' below
    (criterion validated in benchmarks/validate_mixed)."""

    def test_auto_resolves_high_below_threshold(self):
        rng = np.random.default_rng(0)
        x = rng.uniform(0, 1, (50, 2))
        y = rng.standard_normal((4, 50))
        m = LCGP(y=y, x=x, q=2, precision='auto')
        assert m.precision == 'high'
        assert m._compute_dtype is None

    def test_auto_resolves_mixed_at_threshold(self):
        rng = np.random.default_rng(1)
        n = LCGP._AUTO_MIXED_N
        x = rng.uniform(0, 1, (n, 2))
        y = rng.standard_normal((3, n))
        m = LCGP(y=y, x=x, q=2, precision='auto')
        assert m.precision == 'mixed'

    def test_auto_uses_rep_collapsed_n(self):
        # 3000 raw rows but only 100 unique sites: rep grouping shrinks n
        # below the threshold, so 'auto' must resolve on the unique count
        rng = np.random.default_rng(2)
        xu = rng.uniform(0, 1, (100, 2))
        x = np.repeat(xu, 30, axis=0)
        y = rng.standard_normal((3, 3000))
        m = LCGP(y=y, x=x, q=2, submethod='rep', precision='auto')
        assert m.n == 100
        assert m.precision == 'high'

    def test_auto_fit_predict_small(self):
        rng = np.random.default_rng(3)
        x = rng.uniform(0, 1, (60, 2))
        y = np.vstack([np.sin(3 * x[:, 0]), np.cos(2 * x[:, 1])])
        y = y + 0.05 * rng.standard_normal((2, 60))
        m = LCGP(y=y, x=x, q=2, precision='auto')
        l0 = float(m.loss())
        m.fit(method='adam', steps=30)
        assert float(m.loss()) < l0
        yp, ypv, _ = m.predict(x[:5])
        assert np.isfinite(np.asarray(yp)).all()

    def test_mixed_hint_printed_once(self, capsys):
        rng = np.random.default_rng(4)
        x = rng.uniform(0, 1, (60, 2))
        y = rng.standard_normal((2, 60))
        m = LCGP(y=y, x=x, q=2, precision='high')
        m._AUTO_MIXED_N = 50      # make the small model "large" for the hint
        m._AUTO_ONDEVICE_N = 50   # (the hint lives in the large-n branch)
        m.fit(method='adam', steps=2)          # explicit method: no hint
        assert 'hint' not in capsys.readouterr().out
        m.fit(method='scipy', maxiter=2)       # auto only: still no hint
        assert 'hint' not in capsys.readouterr().out
        m.fit(method='auto', maxiter=2)        # non-verbose: stdout stays
        assert 'hint' not in capsys.readouterr().out   # machine-parseable
        m.fit(method='auto', maxiter=2, verbose=True)
        assert "precision='mixed'" in capsys.readouterr().out
        m.fit(method='auto', maxiter=2, verbose=True)  # one-time only
        assert 'hint' not in capsys.readouterr().out
