"""Demonstrate the single-device exact-path ceiling.

The `_auto_q_chunk` device-memory model (LCGP._q_peak_bytes: peak ~=
(8*q_chunk + q) * n^2 * 8 bytes against _HBM_BUDGET_FRACTION of the
device's bytes_limit) predicts where the exact f64/mixed path caps.  This
script runs ONE end-to-end exact fit at a given n — default n=12288, q=2,
p=100 borehole-style field — recording fit wall-clock,
eval rate, predictive quality, and the XLA-compiled memory footprint of
the loss+grad executable, turning the extrapolated ceiling into a
measurement.  Reference scale anchor: its per-k eigh path
(reference lcgp.py:650-652) is O(n^3) per component in NumPy/TF on host —
n=12k is far beyond anything it ships.

Usage: python -u benchmarks/exact_ceiling.py [--cpu] [--n 12288]
         [--precision mixed] [--maxiter 30]
(on CPU use --n 1024 for a smoke run; the full config needs an
accelerator)
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
    ap.add_argument('--precision', default='mixed',
                    choices=['high', 'mixed', 'fast'])
    ap.add_argument('--maxiter', type=int, default=30)
    ap.add_argument('--analyze-only', action='store_true',
                    help='stop after compiling the loss+grad executable and '
                         'printing its XLA memory analysis — brackets the '
                         'OOM point above the demonstrated cap without '
                         'paying a fit')
    args = ap.parse_args()

    if args.cpu:
        import jax
        jax.config.update('jax_platforms', 'cpu')

    import jax
    from lcgp_tpu import LCGP, datasets, evaluation

    n, p = args.n, args.p
    x, y = datasets.make_borehole_field(n=n + 256, p=p, seed=0)
    xtr, ytr = x[:n], y[:, :n]
    xte, yte = x[n:], y[:, n:]

    t0 = time.time()
    m = LCGP(y=ytr, x=xtr, q=args.q, precision=args.precision)
    build_s = time.time() - t0
    print(f'[ceiling] model built in {build_s:.1f}s; '
          f'auto q_chunk={m.q_chunk}', flush=True)

    # compiled-memory footprint of one loss+grad eval (the fit's unit)
    loss = m._loss_fn()
    lowered = jax.jit(jax.value_and_grad(loss)).lower(m._free)
    try:
        compiled = lowered.compile()
    except Exception as e:  # noqa: BLE001 — compile-time memory exhaustion
        msg = str(e)
        if 'RESOURCE_EXHAUSTED' not in msg and 'emory' not in msg:
            raise
        # the allocator error text carries the would-be footprint, e.g.
        # "HLO temp 20.89G (99.9% utilization: Unpadded (12.42G) ...
        #  40.5% fragmentation (8.46G))" — surface it as the OOM bracket
        import re
        mt = re.search(r'HLO temp\s+([\d.]+)G.*?Unpadded \(([\d.]+)G\)'
                       r'.*?([\d.]+)% fragmentation', msg, re.S)
        print(json.dumps(dict(
            n=n, p=p, q=args.q, precision=args.precision,
            q_chunk=m.q_chunk, oom=True,
            lossgrad_temp_gb=float(mt.group(1)) if mt else None,
            lossgrad_temp_unpadded_gb=float(mt.group(2)) if mt else None,
            fragmentation_pct=float(mt.group(3)) if mt else None,
            device=str(jax.devices()[0]),
        )), flush=True)
        return
    ma = compiled.memory_analysis()
    temp_bytes = int(getattr(ma, 'temp_size_in_bytes', 0))
    arg_bytes = int(getattr(ma, 'argument_size_in_bytes', 0))
    print(f'[ceiling] loss+grad compiled: temp={temp_bytes / 1e9:.2f} GB '
          f'args={arg_bytes / 1e9:.2f} GB', flush=True)

    if args.analyze_only:
        print(json.dumps(dict(
            n=n, p=p, q=args.q, precision=args.precision,
            q_chunk=m.q_chunk, analyze_only=True,
            lossgrad_temp_gb=round(temp_bytes / 1e9, 3),
            lossgrad_arg_gb=round(arg_bytes / 1e9, 3),
            device=str(jax.devices()[0]),
        )), flush=True)
        return

    # one timed eval
    v, g = compiled(m._free)
    float(v)
    t0 = time.time()
    v, g = compiled(m._free)
    sv = float(v)
    eval_s = time.time() - t0

    t0 = time.time()
    m.fit(verbose=True, maxiter=args.maxiter)
    fit_s = time.time() - t0

    t0 = time.time()
    yp = np.asarray(m.predict(xte)[0])
    pred_s = time.time() - t0
    nrmse = float(evaluation.normalized_rmse(yte, yp))

    print(json.dumps(dict(
        n=n, p=p, q=args.q, precision=args.precision,
        q_chunk=m.q_chunk,
        lossgrad_temp_gb=round(temp_bytes / 1e9, 3),
        lossgrad_arg_gb=round(arg_bytes / 1e9, 3),
        secs_per_eval=round(eval_s, 3),
        loss_at_init=round(sv, 6),
        fit_secs=round(fit_s, 1),
        fit_nit=int(m._fit_result.nit),
        stop_reason=m._fit_result.stop_reason,
        fitted_loss=float(m._fit_result.fun),
        predict_secs=round(pred_s, 1),
        nrmse=round(nrmse, 5),
        device=str(jax.devices()[0]),
    )), flush=True)


if __name__ == '__main__':
    main()
