"""Multi-chip sharded training demo.

Runs the LCGP loss + on-device Adam over a ('comp','out') device mesh:
latent components shard across 'comp', output dimensions across 'out'.
On a single-chip (or CPU) machine, emulate a mesh with
    XLA_FLAGS=--xla_force_host_platform_device_count=8  and  --cpu.

Usage: python examples/multichip_sharded.py [--cpu] [--n-comp 4] [--n-out 2]
"""
from __future__ import annotations

import argparse
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--cpu', action='store_true')
    ap.add_argument('--n-comp', type=int, default=4)
    ap.add_argument('--n-out', type=int, default=2)
    ap.add_argument('--steps', type=int, default=100)
    args = ap.parse_args()

    if args.cpu:
        import os
        flags = os.environ.get('XLA_FLAGS', '')
        if 'host_platform_device_count' not in flags:
            os.environ['XLA_FLAGS'] = (
                flags + ' --xla_force_host_platform_device_count='
                + str(args.n_comp * args.n_out)).strip()
        import jax
        jax.config.update('jax_platforms', 'cpu')

    import jax
    from lcgp_tpu import LCGP, parallel
    from lcgp_tpu.models import likelihood as lik

    print(f'devices: {len(jax.devices())}')
    mesh = parallel.make_mesh(n_comp=args.n_comp, n_out=args.n_out)
    print(f'mesh: {mesh}')

    rng = np.random.default_rng(0)
    q = args.n_comp * 2
    p = max(args.n_out * 8, q)
    x = rng.uniform(0, 1, (256, 4))
    y = (np.sin(2 * np.pi * np.linspace(0, 1, p))[:, None] * x[:, 0][None, :]
         + 0.1 * rng.standard_normal((p, 256)))

    model = LCGP(y=y, x=x, q=q)
    single = float(model.loss())

    vg = parallel.make_sharded_value_and_grad(mesh, model._data)
    free_s = parallel.place(model._free, parallel.param_shardings(mesh))
    data_s = parallel.place(model._data,
                            parallel.data_shardings(mesh, model._data))
    v, g = vg(free_s, data_s)
    print(f'sharded loss {float(v):.6f} vs single-device {single:.6f}')

    t0 = time.time()
    free_fit, fit_res = parallel.fit_sharded(
        model._data, model._free, mesh, steps=args.steps, learning_rate=3e-2)
    print(f'{args.steps} sharded Adam steps in {time.time() - t0:.2f}s; '
          f'loss {single:.4f} -> {float(fit_res.fun):.4f} '
          f'(stop: {fit_res.stop_reason})')

    # n-axis sharding: distributed blocked Cholesky over all devices.
    # End-to-end through the model API: fit(mesh=...) runs the
    # distributed loss+grad with the memory-bounded custom-VJP backward,
    # and predict() runs the n-sharded aux/predict path.
    from lcgp_tpu.parallel import nshard
    nmesh = nshard.make_n_mesh()
    model_n = LCGP(y=y, x=x, q=q)
    t0 = time.time()
    model_n.fit(mesh=nmesh, method='adam', steps=args.steps,
                learning_rate=3e-2)
    x0 = rng.uniform(0, 1, (8, 4))
    yp = np.asarray(model_n.predict(x0)[0])
    single_model = LCGP(y=y, x=x, q=q)
    single_model._free = model_n._free
    single_model._params_version += 1
    yp_ref = np.asarray(single_model.predict(x0)[0])
    print(f'n-sharded fit+predict over {nmesh.devices.size} devices in '
          f'{time.time() - t0:.2f}s; predict vs single-device max diff '
          f'{np.max(np.abs(yp - yp_ref)):.2e}')

    # FITC + n-sharding: the (q, n, m) inducing-point Woodbury
    # panel distributes its rows over the same ('n',) mesh — exact same
    # estimator, per-device memory / GEMM time divided by the mesh size.
    model_f = LCGP(y=y, x=x, q=q, inducing=32)
    t0 = time.time()
    model_f.fit(mesh=nmesh, method='adam', steps=args.steps,
                learning_rate=3e-2)
    ypf = np.asarray(model_f.predict(x0)[0])
    single_f = LCGP(y=y, x=x, q=q, inducing=32)
    single_f._free, single_f._z = model_f._free, model_f._z
    single_f._params_version += 1
    ypf_ref = np.asarray(single_f.predict(x0)[0])
    print(f'n-sharded FITC (m=32) fit+predict in {time.time() - t0:.2f}s; '
          f'predict vs single-device max diff '
          f'{np.max(np.abs(ypf - ypf_ref)):.2e}')

    # 2-D ('comp','n') mesh: q components shard over 'comp' groups, each
    # group runs the distributed blocked Cholesky over its 'n' submesh —
    # this keeps the factorization's sequential panel loop at the n-axis
    # size (comp=2 x n=2 on 4 devices -> 2 panel steps, not 4).  Same API; exact and FITC paths both ride it.
    if len(jax.devices()) >= 4:
        ncmesh = nshard.make_nc_mesh(2, len(jax.devices()) // 2)
        model_c = LCGP(y=y, x=x, q=q)
        t0 = time.time()
        model_c.fit(mesh=ncmesh, method='adam', steps=args.steps,
                    learning_rate=3e-2)
        ypc = np.asarray(model_c.predict(x0)[0])
        single_c = LCGP(y=y, x=x, q=q)
        single_c._free = model_c._free
        single_c._params_version += 1
        ypc_ref = np.asarray(single_c.predict(x0)[0])
        print(f"('comp','n') {dict(ncmesh.shape)} fit+predict in "
              f'{time.time() - t0:.2f}s; predict vs single-device max '
              f'diff {np.max(np.abs(ypc - ypc_ref)):.2e}')


if __name__ == '__main__':
    main()
