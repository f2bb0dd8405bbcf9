"""Per-device memory table for the n-sharded FITC loss 

The FITC working set is the (q, n, m) Woodbury panel (plus its autodiff
residuals); parallel/fitc_shard splits the panel's rows across the mesh.
This prints XLA's compiled per-SPMD-program memory for value_and_grad of
the sharded loss on the virtual 8-device CPU mesh vs the single-device
sparse path — the numbers that justify "the single-device FITC n-ceiling
scales linearly with the mesh".

  PYTHONPATH=. python -u benchmarks/fitc_shard_memory.py [n ...]
"""
from __future__ import annotations

import json
import os
import sys

flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np
import jax.numpy as jnp

from lcgp_tpu.models import basis as basis_mod
from lcgp_tpu.models import likelihood as lik
from lcgp_tpu.models import params as P
from lcgp_tpu.models import sparse
from lcgp_tpu.parallel import fitc_shard, nshard


def problem(n, q=4, p=16, d=4, seed=0):
    rng = np.random.default_rng(seed)
    xs = rng.uniform(0, 1, (n, d))
    ys = rng.standard_normal((p, n))
    ys = (ys - ys.mean(1, keepdims=True)) / ys.std(1, keepdims=True)
    b = basis_mod.init_phi(ys, q=q)
    data = lik.FullData(xs=jnp.asarray(xs), ys=jnp.asarray(ys),
                        phi=jnp.asarray(b.phi), diag_D=jnp.asarray(b.diag_D),
                        sigma_map=jnp.asarray(P.sigma_index_map([1] * p)))
    free = P.init_values(xs, ys, b.q, [1] * p)
    return data, free


def temp_bytes(loss, free):
    vg = jax.jit(jax.value_and_grad(loss))
    compiled = vg.lower(free).compile()
    ma = compiled.memory_analysis()
    return int(getattr(ma, 'temp_size_in_bytes', 0))


def main():
    ns = [int(a) for a in sys.argv[1:]] or [16384, 32768, 65536]
    m = 256
    mesh = nshard.make_n_mesh(8)
    rows = []
    for n in ns:
        data, free = problem(n)
        z = jnp.asarray(sparse.select_inducing(np.asarray(data.xs), m))
        single = temp_bytes(
            lambda f: sparse.neglpost_full_fitc(f, data, z), free)
        shard = temp_bytes(
            lambda f: fitc_shard.neglpost_full_fitc_nsharded(
                f, data, z, mesh), free)
        rows.append(dict(n=n, m=m,
                         single_device_mb=round(single / 1e6, 1),
                         nshard8_per_device_mb=round(shard / 1e6, 1),
                         ratio=round(single / max(shard, 1), 2)))
        print(json.dumps(rows[-1]), flush=True)
    print(json.dumps(dict(all=rows)))


if __name__ == '__main__':
    main()
