"""FITC accuracy-vs-m curve.

Fits inducing-point models at m in {64,128,256,512} on the config-6-style
large-n borehole field problem, with and without gradient refinement of
the inducing locations, and prints nrmse + clamp stats per row.

  python -u benchmarks/fitc_m_curve.py \
      [--n 50000] [--cpu] [--ms 64,128,256,512] [--refine-steps 150]
"""
from __future__ import annotations

import argparse
import json
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--n', type=int, default=50_000)
    ap.add_argument('--ms', default='64,128,256,512')
    ap.add_argument('--cpu', action='store_true')
    ap.add_argument('--refine-steps', type=int, default=150)
    ap.add_argument('--fit-steps', type=int, default=300)
    args = ap.parse_args()

    if args.cpu:
        import jax
        jax.config.update('jax_platforms', 'cpu')

    import numpy as np
    from lcgp_tpu import LCGP, datasets, evaluation

    n_test = 2000
    x_all, y_all = datasets.make_borehole_field(n=args.n + n_test, p=20,
                                                seed=0)
    x, xte = x_all[:args.n], x_all[args.n:]
    y, yte = y_all[:, :args.n], y_all[:, args.n:]

    for m in [int(s) for s in args.ms.split(',')]:
        for refine in (False, True):
            t0 = time.time()
            model = LCGP(y=y, x=x, q=5, inducing=m, precision='fast')
            model.fit(method='adam', steps=args.fit_steps,
                      learning_rate=5e-2)
            if refine:
                model.refine_inducing(steps=args.refine_steps,
                                      learning_rate=5e-3, joint=True)
            yp, ypv, _ = model.predict(xte, batch_size=512)
            secs = time.time() - t0
            print(json.dumps(dict(
                m=m, refined=refine,
                nrmse=round(float(evaluation.normalized_rmse(
                    yte, np.asarray(yp))), 5),
                clamp_frac=(model._fitc_clamp_stats or {}).get('frac'),
                secs=round(secs, 1))), flush=True)


if __name__ == '__main__':
    main()
