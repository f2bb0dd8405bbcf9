"""Run the five BASELINE.json benchmark configs end-to-end and report
fit time + accuracy/UQ metrics as JSON lines.

  1. 1-D replication illustration (n~100 obs)
  2. 1-D 3-output skewed replication, heteroskedastic noise (Case 2)
  3. Borehole-style emulator: n=1000, d=8, p=100, q=5
  4. Large field: n=4096, p=1000, q=20, diagonal error
  5. Replication-heavy: 10k sims with ~10x replicates + full predictive UQ

Usage: python benchmarks/run_configs.py [--cpu] [--configs 1,2,3]
       [--method auto|scipy|adam|lbfgs-jax] [--precision high|mixed|fast]
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np


def _metrics(ytrue, ypred, ypredvar):
    from lcgp_tpu import evaluation
    cover, width = evaluation.intervalstats(ytrue, ypred, ypredvar)
    return dict(
        rmse=float(evaluation.rmse(ytrue, ypred)),
        nrmse=float(evaluation.normalized_rmse(ytrue, ypred)),
        coverage=float(cover), width=float(width),
        dss=float(evaluation.dss(ytrue, ypred, ypredvar, use_diag=True)),
    )


def config1():
    from lcgp_tpu import datasets
    xtr, ytr, xte, ytrue = datasets.make_rep_data_1d(
        n_unique=16, rep_choices=(1, 2, 3, 4, 5), seed=2025)
    return dict(name='rep_1d_uniform', x=xtr, y=ytr, xte=xte, ytrue=ytrue,
                kwargs=dict(submethod='rep', diag_error_structure=[1, 1, 1]))


def config2():
    from lcgp_tpu import datasets
    xtr, ytr, xte, ytrue = datasets.make_rep_data_skewed(seed=42)
    return dict(name='rep_1d_skewed', x=xtr, y=ytr, xte=xte, ytrue=ytrue,
                kwargs=dict(submethod='rep', diag_error_structure=[1, 1, 1]))


def config3():
    from lcgp_tpu import datasets
    x, y = datasets.make_borehole_field(n=1250, p=100, seed=0)
    return dict(name='borehole_n1000_p100_q5', x=x[:1000], y=y[:, :1000],
                xte=x[1000:], ytrue=y[:, 1000:],
                kwargs=dict(q=5))


def config4():
    rng = np.random.default_rng(0)
    n, p, d, q = 4096, 1000, 8, 20
    x = rng.uniform(0, 1, (n + 256, d))
    t = np.linspace(0, 1, p)[:, None]
    y = (np.sin(2 * np.pi * (t + x[:, :1].T)) + np.cos(np.pi * t * x[:, 1:2].T)
         + 0.05 * rng.standard_normal((p, n + 256)))
    # q_chunk: the (q,n,n) stacks at this scale must be processed in
    # memory-bounded chunks (see likelihood._map_components)
    return dict(name='large_field_n4096_p1000_q20', x=x[:n], y=y[:, :n],
                xte=x[n:], ytrue=y[:, n:], kwargs=dict(q=q, q_chunk=10))


def config5():
    from lcgp_tpu import datasets
    rng = np.random.default_rng(7)
    n_unique, reps = 1000, 10
    xu = rng.uniform(0, 1, (n_unique, 4))
    f = np.vstack([np.sin(2 * np.pi * xu[:, 0]) * xu[:, 1],
                   np.cos(np.pi * xu[:, 2]) + xu[:, 3] ** 2,
                   xu[:, 0] * xu[:, 2]])
    noise = np.array([0.05, 0.1, 0.2])
    x = np.repeat(xu, reps, axis=0)
    y = (np.repeat(f, reps, axis=1)
         + rng.standard_normal((3, n_unique * reps)) * noise[:, None])
    xte = rng.uniform(0, 1, (400, 4))
    fte = np.vstack([np.sin(2 * np.pi * xte[:, 0]) * xte[:, 1],
                     np.cos(np.pi * xte[:, 2]) + xte[:, 3] ** 2,
                     xte[:, 0] * xte[:, 2]])
    return dict(name='rep_heavy_10k', x=x, y=y, xte=xte, ytrue=fte,
                kwargs=dict(submethod='rep', diag_error_structure=[1, 1, 1]),
                true_noise=noise)


def config6():
    """n=50k inducing-point demo: the exact path needs an 80 GB (q,n,n)
    stack here (OOM on any single chip); FITC at m=256 fits in ~0.5 GB.
    d=2 so the m inducing points resolve the kernel's lengthscales
    (spacing ~1/16 per dim) — the regime FITC is for."""
    rng = np.random.default_rng(11)
    n, d, p, q, m = 50_000, 2, 20, 4, 256
    x = rng.uniform(0, 1, (n + 500, d))
    t = np.linspace(0, 1, p)[:, None]
    f = (np.sin(2 * np.pi * (t + x[:, :1].T)) * x[:, 1:2].T
         + np.cos(np.pi * t * x[:, 1:2].T))
    y = f + 0.05 * rng.standard_normal(f.shape)
    return dict(name='fitc_n50k_m256', x=x[:n], y=y[:, :n],
                xte=x[n:], ytrue=f[:, n:],
                kwargs=dict(q=q, inducing=m))


def config7():
    """n=400k inducing-point scale demo: 8x config 6, m=512.
    The exact path's (q,n,n) stack would be 5 TB; FITC's (q,n,m) f64
    panels are ~6.6 GB each and the per-eval cost stays O(n m^2).  Same
    field family as config 6 with one extra input-frequency octave so
    m=512 has structure to resolve.  Forced un-chunked (n_chunk=0)."""
    rng = np.random.default_rng(13)
    n, d, p, q, m = 400_000, 2, 20, 4, 512
    x = rng.uniform(0, 1, (n + 500, d))
    t = np.linspace(0, 1, p)[:, None]
    f = (np.sin(2 * np.pi * (t + x[:, :1].T)) * x[:, 1:2].T
         + np.cos(np.pi * t * x[:, 1:2].T)
         + 0.3 * np.sin(4 * np.pi * x[:, :1].T + np.pi * t))
    y = f + 0.05 * rng.standard_normal(f.shape)
    return dict(name='fitc_n400k_m512', x=x[:n], y=y[:, :n],
                xte=x[n:], ytrue=f[:, n:],
                kwargs=dict(q=q, inducing=m, n_chunk=0))


def config8():
    """n=2M streaming-FITC demo: past what an un-chunked backward holds
    on one device (LCGP._fitc_peak_bytes), the n-blocked streaming loss
    (models/sparse._fitc_stream, auto n_chunk) scans 32768-point blocks
    with a rematerialized backward, so the only n-sized residents are
    the (q, n)/(p, n) data arrays (~0.5 GB here) — single-chip n is
    bounded by data size, not by the factorization."""
    rng = np.random.default_rng(17)
    n, d, p, q, m = 2_000_000, 2, 20, 4, 512
    x = rng.uniform(0, 1, (n + 500, d))
    t = np.linspace(0, 1, p)[:, None]
    f = (np.sin(2 * np.pi * (t + x[:, :1].T)) * x[:, 1:2].T
         + np.cos(np.pi * t * x[:, 1:2].T)
         + 0.3 * np.sin(4 * np.pi * x[:, :1].T + np.pi * t))
    y = f + 0.05 * rng.standard_normal(f.shape)
    return dict(name='fitc_n2M_m512_stream', x=x[:n], y=y[:, :n],
                xte=x[n:], ytrue=f[:, n:],
                kwargs=dict(q=q, inducing=m))


CONFIGS = {1: config1, 2: config2, 3: config3, 4: config4, 5: config5,
           6: config6, 7: config7, 8: config8}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--cpu', action='store_true')
    ap.add_argument('--configs', default='1,2,3,4,5')
    ap.add_argument('--method', default='auto')
    ap.add_argument('--precision', default='high')
    ap.add_argument('--maxiter', type=int, default=None)
    ap.add_argument('--steps', type=int, default=None,
                    help='adam steps')
    ap.add_argument('--lr', type=float, default=None, help='adam lr')
    ap.add_argument('--block-steps', type=int, default=None,
                    help='adam dispatch block length')
    ap.add_argument('--block-iters', type=int, default=None,
                    help='on-device L-BFGS dispatch block length (iterations '
                         'between host syncs)')
    args = ap.parse_args()

    if args.cpu:
        import jax
        jax.config.update('jax_platforms', 'cpu')

    from lcgp_tpu import LCGP

    for idx in [int(s) for s in args.configs.split(',')]:
        cfg = CONFIGS[idx]()
        t0 = time.time()
        model = LCGP(y=cfg['y'], x=cfg['x'], precision=args.precision,
                     **cfg['kwargs'])
        build_s = time.time() - t0

        fit_kwargs = {}
        if args.maxiter:
            fit_kwargs['maxiter'] = args.maxiter
        if args.block_iters and args.method == 'lbfgs-jax':
            fit_kwargs['block_iters'] = args.block_iters
        if args.method == 'adam':
            fit_kwargs.pop('maxiter', None)
            if args.steps:
                fit_kwargs['steps'] = args.steps
            if args.lr:
                fit_kwargs['learning_rate'] = args.lr
            if args.block_steps:
                fit_kwargs['block_steps'] = args.block_steps
        t0 = time.time()
        model.fit(method=args.method, **fit_kwargs)
        fit_s = time.time() - t0

        t0 = time.time()
        ypred, ypredvar, yconfvar = map(np.asarray,
                                        model.predict(cfg['xte']))
        predict_s = time.time() - t0

        rec = dict(config=cfg['name'], n=model.n, p=int(model.p),
                   q=int(model.q), N_obs=cfg['x'].shape[0],
                   build_s=round(build_s, 2), fit_s=round(fit_s, 2),
                   predict_s=round(predict_s, 2),
                   **{k: round(v, 5) for k, v in
                      _metrics(cfg['ytrue'], ypred, ypredvar).items()})
        if 'true_noise' in cfg:
            rec['fitted_noise_std'] = [round(float(s), 4) for s in
                                       np.sqrt(np.exp(np.asarray(model.lsigma2s)))]
            rec['true_noise_std'] = list(cfg['true_noise'])
        print(json.dumps(rec), flush=True)


if __name__ == '__main__':
    main()
