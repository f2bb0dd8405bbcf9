"""Warm predict latency vs precision.

Measures the p50/p95 of warm, single-request predictions through the
microbatching ``PredictServer`` for every precision tier, at two model
scales:

  - serving-sized: the skewed 1-D replication model (n_unique=40, p=3) the
    serving benchmarks use,
  - headline-sized: n=4096, p=1000, q=20 full-path model (BASELINE config 4
    shapes; parameters at init — latency is shape-, not value-, dependent).

Results let a reader pick a precision for a latency SLO.  One JSON line per
(scale, precision); a trailing line aggregates the table.

  python -u benchmarks/predict_latency.py [--cpu]
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

PRECISIONS = ('high', 'mixed', 'fast')


def measure(model, xtr, requests=40, batch_size=256, seed=0):
    from lcgp_tpu.serve import PredictServer
    srv = PredictServer(model, batch_size=batch_size, warmup=True)
    rng = np.random.default_rng(seed)
    d = xtr.shape[1]
    sizes = rng.integers(1, min(128, batch_size), size=requests)
    xs = [rng.uniform(0.0, 1.0, (int(s), d)) for s in sizes]
    srv.predict(xs[0])                      # warm the padded shape
    lats = []
    for x in xs:
        t0 = time.time()
        srv.predict(x)
        lats.append(time.time() - t0)
    srv.shutdown()
    return (round(float(np.percentile(lats, 50)) * 1e3, 1),
            round(float(np.percentile(lats, 95)) * 1e3, 1))


def serving_sized(precision, fit_steps):
    from lcgp_tpu import LCGP, datasets
    xtr, ytr, _, _ = datasets.make_rep_data_skewed(seed=7)
    model = LCGP(y=ytr, x=xtr, q=3, submethod='rep', precision=precision)
    if fit_steps:
        model.fit(method='adam', steps=fit_steps)
    return model, xtr


def headline_sized(precision):
    from lcgp_tpu import LCGP
    n, p, d, q = 4096, 1000, 8, 20
    rng = np.random.default_rng(0)
    xs = rng.uniform(0, 1, (n, d))
    t = np.linspace(0, 1, p)[:, None]
    ys = (np.sin(2 * np.pi * (t + xs[:, :1].T)) +
          0.05 * rng.standard_normal((p, n)))
    model = LCGP(y=ys, x=xs, q=q, precision=precision)
    return model, xs


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--cpu', action='store_true')
    ap.add_argument('--requests', type=int, default=40)
    ap.add_argument('--fit-steps', type=int, default=60)
    ap.add_argument('--skip-headline', action='store_true')
    args = ap.parse_args()
    if args.cpu:
        import jax
        jax.config.update('jax_platforms', 'cpu')

    table = {}
    for precision in PRECISIONS:
        model, xtr = serving_sized(precision, args.fit_steps)
        p50, p95 = measure(model, xtr, requests=args.requests)
        row = dict(scale='serving_n40_p3', precision=precision,
                   p50_ms=p50, p95_ms=p95)
        print(json.dumps(row), flush=True)
        table[f'serving_{precision}'] = (p50, p95)
        del model

    if not args.skip_headline:
        for precision in PRECISIONS:
            model, xtr = headline_sized(precision)
            t0 = time.time()
            p50, p95 = measure(model, xtr, requests=args.requests)
            row = dict(scale='headline_n4096_p1000_q20', precision=precision,
                       p50_ms=p50, p95_ms=p95,
                       cold_total_s=round(time.time() - t0, 1))
            print(json.dumps(row), flush=True)
            table[f'headline_{precision}'] = (p50, p95)
            del model

    print(json.dumps({'table': table}))


if __name__ == '__main__':
    main()
