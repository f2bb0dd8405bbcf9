"""Warm predict cost at the exact-path ceiling (round-4 mixed-aux change).

`exact_ceiling.py`'s predict_secs is COLD — it includes compiling the
aux/predict executables, which hides the factorization cost the mixed aux
actually removes.  This probe times
the steady-state number: predict once (compiles everything), then
invalidate the aux cache exactly as a post-refit parameter change would
(bump _params_version) and re-time predict with warm executables.  That
second figure is what a user pays to predict after every refit.

Usage: python -u benchmarks/predict_warm.py [--cpu] [--n 12288]
         [--precision mixed|high] [--n0 256]
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--cpu', action='store_true')
    ap.add_argument('--n', type=int, default=12288)
    ap.add_argument('--p', type=int, default=100)
    ap.add_argument('--q', type=int, default=2)
    ap.add_argument('--n0', type=int, default=256)
    ap.add_argument('--precision', default='mixed',
                    choices=['high', 'mixed', 'fast'])
    args = ap.parse_args()

    if args.cpu:
        import jax
        jax.config.update('jax_platforms', 'cpu')

    import jax
    from lcgp_tpu import LCGP, datasets, evaluation

    n, p = args.n, args.p
    x, y = datasets.make_borehole_field(n=n + args.n0, p=p, seed=0)
    xtr, ytr = x[:n], y[:, :n]
    xte, yte = x[n:], y[:, n:]

    m = LCGP(y=ytr, x=xtr, q=args.q, precision=args.precision)
    print(f'[warm] model built; q_chunk={m.q_chunk}', flush=True)

    t0 = time.time()
    yp = np.asarray(m.predict(xte)[0])
    cold_s = time.time() - t0
    print(f'[warm] cold predict (incl. compile): {cold_s:.1f}s', flush=True)

    # invalidate the aux exactly as a parameter update does: the next
    # predict recomputes the one-shot factorization with warm executables
    m._aux = None
    m._params_version += 1
    t0 = time.time()
    yp = np.asarray(m.predict(xte)[0])
    warm_s = time.time() - t0

    print(json.dumps(dict(
        n=n, p=p, q=args.q, n0=args.n0, precision=args.precision,
        q_chunk=m.q_chunk,
        predict_cold_secs=round(cold_s, 1),
        predict_warm_secs=round(warm_s, 1),
        nrmse=round(float(evaluation.normalized_rmse(yte, yp)), 5),
        device=str(jax.devices()[0]),
    )), flush=True)


if __name__ == '__main__':
    main()
