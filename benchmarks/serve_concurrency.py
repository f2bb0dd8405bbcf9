"""Serving concurrency benchmark.

Measures single-client latency, then k concurrent clients with mixed
request sizes, through the microbatching PredictServer (in-process, no
HTTP — the dispatcher is what's under test).  Checks values against
model.predict and prints one JSON line per scenario.

  python -u benchmarks/serve_concurrency.py [--cpu]
"""
from __future__ import annotations

import argparse
import json
import threading
import time

import numpy as np


def run_clients(srv, inputs, n_rounds=5):
    """Each client fires its request n_rounds times; returns all latencies."""
    lats = [[] for _ in inputs]
    errs = []

    def worker(i):
        try:
            for _ in range(n_rounds):
                t0 = time.time()
                srv.predict(inputs[i])
                lats[i].append(time.time() - t0)
        except Exception as e:  # noqa: BLE001
            errs.append(repr(e))

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(len(inputs))]
    t0 = time.time()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.time() - t0
    if errs:
        raise RuntimeError(errs)
    flat = [v for l in lats for v in l]
    return flat, wall


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--cpu', action='store_true')
    ap.add_argument('--clients', type=int, default=8)
    ap.add_argument('--rounds', type=int, default=5)
    args = ap.parse_args()

    if args.cpu:
        import jax
        jax.config.update('jax_platforms', 'cpu')

    from lcgp_tpu import LCGP, datasets
    from lcgp_tpu.serve import PredictServer

    xtr, ytr, _, _ = datasets.make_rep_data_skewed(seed=7)
    model = LCGP(y=ytr, x=xtr, q=3, submethod='rep')
    model.fit(method='adam', steps=100)
    srv = PredictServer(model, batch_size=256, warmup=True)

    rng = np.random.default_rng(0)
    sizes = [1, 3, 7, 16, 31, 63, 100, 127][:args.clients]
    inputs = [rng.uniform(xtr.min(), xtr.max(), (s, xtr.shape[1]))
              for s in sizes]

    # correctness under concurrency
    expected = [tuple(np.asarray(o) for o in model.predict(x))
                for x in inputs]
    results = [srv.predict(x) for x in inputs]
    for got, exp in zip(results, expected):
        for g, e in zip(got, exp):
            np.testing.assert_allclose(g, e, rtol=1e-10, atol=1e-12)

    # single-client baseline (size-16 request)
    single, _ = run_clients(srv, [inputs[3]], n_rounds=10)
    p50_single = float(np.percentile(single, 50))

    # k concurrent clients
    flat, wall = run_clients(srv, inputs, n_rounds=args.rounds)
    srv.shutdown()
    p50 = float(np.percentile(flat, 50))
    p95 = float(np.percentile(flat, 95))
    print(json.dumps(dict(
        clients=len(sizes), sizes=sizes, rounds=args.rounds,
        single_client_p50_ms=round(p50_single * 1e3, 1),
        concurrent_p50_ms=round(p50 * 1e3, 1),
        concurrent_p95_ms=round(p95 * 1e3, 1),
        p95_vs_single_p50=round(p95 / p50_single, 2),
        wall_s=round(wall, 2),
        values_match='1e-10',
    )))


if __name__ == '__main__':
    main()
