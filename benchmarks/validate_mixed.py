"""Validate precision='mixed' against the f64 path on the BASELINE configs.

For each config: build the model in 'high' (f64) and 'mixed', then compare
  - loss at the data-driven init,
  - loss gradient at init (max relative error over parameter leaves),
  - loss and predictions at the *fitted* hyperparameters (fit the f64
    model, copy its parameters into the mixed model) — the fitted regime
    is where the factor-target conditioning is worst, so this is the
    stress test of the refinement.

Usage: python benchmarks/validate_mixed.py [--cpu] [--configs 1,2,5]
       [--maxiter 150]
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np


def _rel(a, b):
    a = np.asarray(a, dtype=float)
    b = np.asarray(b, dtype=float)
    denom = np.maximum(np.abs(a), 1e-12)
    return float(np.max(np.abs(a - b) / denom))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--cpu', action='store_true')
    ap.add_argument('--configs', default='1,2,3,4,5')
    ap.add_argument('--maxiter', type=int, default=150)
    ap.add_argument('--params-ckpt', default=None,
                    help='npz path prefix: after fitting the f64 model, save '
                         'its free params to <prefix>_<config>.npz; if that '
                         'file already exists, load it instead of fitting '
                         '(the big-config f64 fit is the slow part — pay it '
                         'once)')
    args = ap.parse_args()

    if args.cpu:
        import jax
        jax.config.update('jax_platforms', 'cpu')

    import jax
    import jax.numpy as jnp
    from lcgp_tpu import LCGP
    from run_configs import CONFIGS

    for idx in [int(s) for s in args.configs.split(',')]:
        cfg = CONFIGS[idx]()
        kw = dict(cfg['kwargs'])
        # config kwargs may pin q_chunk for the f32/'fast' runs; here both
        # models are f64-grade — let _auto_q_chunk size the chunk to memory
        # (explicit q_chunk=10 OOMs the mixed forward at the n=4096 config:
        # the f64 refinement residuals live alongside the f32 seed chol)
        kw.pop('q_chunk', None)
        hi = LCGP(y=cfg['y'], x=cfg['x'], precision='high', **kw)
        mx = LCGP(y=cfg['y'], x=cfg['x'], precision='mixed', **kw)

        loss_hi0, loss_mx0 = float(hi.loss()), float(mx.loss())

        g_hi = jax.grad(hi._loss_fn())(hi._free)
        g_mx = jax.grad(mx._loss_fn())(mx._free)
        grad_rel = max(_rel(a, b) for a, b in
                       zip(jax.tree.leaves(g_hi), jax.tree.leaves(g_mx)))

        # both the scipy and the on-device L-BFGS accept maxiter; cap it so
        # the large configs validate in bounded time (the comparison is at
        # whatever point the fit reached — conditioning grows with fitting,
        # so any fitted point stresses the refinement more than init)
        ckpt = (f'{args.params_ckpt}_{cfg["name"]}.npz'
                if args.params_ckpt else None)
        if ckpt and os.path.exists(ckpt):
            z = np.load(ckpt, allow_pickle=False)
            hi._free = type(hi._free)(*[jnp.asarray(z[k]) for k in
                                        ('lLmb', 'lLmb0', 'lsigma2s',
                                         'lnugGPs')])
            hi._params_version += 1
            print(f'[validate_mixed] loaded fitted params from {ckpt}',
                  flush=True)
        else:
            hi.fit(maxiter=args.maxiter)
            if ckpt:
                np.savez(ckpt, **{k: np.asarray(getattr(hi._free, k)) for k
                                  in ('lLmb', 'lLmb0', 'lsigma2s',
                                      'lnugGPs')})
                print(f'[validate_mixed] saved fitted params to {ckpt}',
                      flush=True)
        mx._free = hi._free
        mx._params_version += 1

        loss_hi1, loss_mx1 = float(hi.loss()), float(mx.loss())
        yp_hi, ypv_hi, _ = map(np.asarray, hi.predict(cfg['xte']))
        yp_mx, ypv_mx, _ = map(np.asarray, mx.predict(cfg['xte']))

        amp = np.asarray(hi.lLmb0)
        print(json.dumps(dict(
            config=cfg['name'],
            loss_rel_init=_rel(loss_hi0, loss_mx0),
            grad_rel_init=grad_rel,
            loss_rel_fitted=_rel(loss_hi1, loss_mx1),
            pred_mean_rel_fitted=_rel(yp_hi, yp_mx),
            pred_var_rel_fitted=_rel(ypv_hi, ypv_mx),
            fitted_amp_max=float(amp.max()),
        )), flush=True)


if __name__ == '__main__':
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    main()
