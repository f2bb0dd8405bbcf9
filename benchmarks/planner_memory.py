"""Device memory of one loss+grad against the memory planner's models.

For each configuration — exact (n, q, precision, q_chunk) or FITC
(n, q, m, n_chunk) — the script builds the model through the public
constructor, compiles the jitted loss+grad the optimizers run, and
records XLA's compiled memory (arguments + outputs + temporaries,
``compiled.memory_analysis()``) beside the planner's prediction
(``LCGP._q_peak_bytes`` / ``LCGP._fitc_peak_bytes``); for FITC also the
compiled memory of the predictive aux.  It then runs the loss+grad
configurations in increasing order of compiled memory and records the
device's ``peak_bytes_in_use``
after each — a cumulative peak, so in that order it is each
configuration's own.  Configurations whose compiled memory exceeds the
device's ``bytes_limit`` are compiled but not run.

  python benchmarks/planner_memory.py            # on the accelerator
  python benchmarks/planner_memory.py --fitc     # the FITC configurations
  python benchmarks/planner_memory.py --small    # CPU smoke run

Prints one JSON line per configuration and a final {"table": [...]}.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# (n, q, precision, chunk, m): chunk is q_chunk (exact, m=None) or n_chunk
# (FITC); chunk None = unchunked
FULL = [
    (4096, 20, 'high', 1, None), (4096, 20, 'high', 5, None),
    (4096, 20, 'high', 10, None), (4096, 20, 'high', None, None),
    (4096, 20, 'fast', 5, None), (4096, 20, 'fast', None, None),
    (4096, 20, 'mixed', None, None),
    (8192, 20, 'high', 1, None), (8192, 20, 'high', 5, None),
]
FITC = [(50_000, 5, 'high', None, 512), (200_000, 5, 'high', None, 512),
        (200_000, 5, 'high', 8192, 512)]
SMALL = [(256, 4, 'high', 1, None), (256, 4, 'high', None, None),
         (256, 4, 'fast', None, None), (256, 4, 'mixed', None, None),
         (600, 3, 'high', None, 16), (600, 3, 'high', 128, 16)]


def _bytes(compiled):
    ma = compiled.memory_analysis()
    return int(ma.argument_size_in_bytes + ma.output_size_in_bytes
               + ma.temp_size_in_bytes - ma.alias_size_in_bytes)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--small', action='store_true')
    ap.add_argument('--fitc', action='store_true')
    args = ap.parse_args(argv)

    import jax
    from lcgp_tpu import LCGP
    from lcgp_tpu.fit.auxloss import split_aux
    from lcgp_tpu.models import sparse

    dev = jax.devices()[0]
    limit = (dev.memory_stats() or {}).get('bytes_limit')
    configs = SMALL if args.small else FITC if args.fitc else FULL
    rows, runs = [], []
    for n, q, precision, chunk, m in configs:
        p = 20 if args.small else 100 if m else 1000
        rng = np.random.default_rng(n)
        x = rng.uniform(0, 1, (n, 8))
        t = np.linspace(0, 1, p)[:, None]
        y = (np.sin(2 * np.pi * (t + x[:, :1].T))
             + 0.05 * rng.standard_normal((p, n)))
        chunk_arg = 0 if chunk is None else chunk
        if m is None:
            model = LCGP(y, x, q=q, precision=precision, q_chunk=chunk_arg)
            planner = LCGP._q_peak_bytes(q, chunk or q, n, precision)
        else:
            model = LCGP(y, x, q=q, precision=precision, inducing=m,
                         n_chunk=chunk_arg)
            planner = LCGP._fitc_peak_bytes(q, n, m, precision)
        fn, aux = split_aux(model._loss_fn())
        compiled = jax.jit(jax.value_and_grad(fn)).lower(
            model._free, aux).compile()
        total = _bytes(compiled)
        row = dict(n=n, q=q, precision=precision, m=m, chunk=chunk,
                   planner_bytes=planner, compiled_bytes=total)
        if m is not None:
            row['aux_compiled_bytes'] = _bytes(sparse.compute_aux_fitc.lower(
                model._free, model._data, model._z, 'full',
                n_chunk=model.n_chunk).compile())
        rows.append(row)
        runs.append((total, row, compiled, model._free, aux))
        print(json.dumps(row), flush=True)
    for total, row, compiled, free, aux in sorted(runs, key=lambda r: r[0]):
        if limit and total > limit:
            row['peak_bytes_in_use'] = None
            continue
        jax.block_until_ready(compiled(free, aux))
        row['peak_bytes_in_use'] = (dev.memory_stats() or {}).get(
            'peak_bytes_in_use')
    print(json.dumps({'device': dev.device_kind, 'bytes_limit': limit,
                      'table': rows}), flush=True)


if __name__ == '__main__':
    main()
