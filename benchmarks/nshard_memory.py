"""Per-device backward-memory table for the n-sharded loss.

Compares XLA's compiled memory stats for value_and_grad of the n-sharded
full loss with the custom-VJP backward (closed-form gradient from the
saved distributed factor) vs plain autodiff through the unrolled
distributed blocked Cholesky.  Runs on the virtual 8-device CPU mesh; the
stats are per-SPMD-program, i.e. per device.

  PYTHONPATH=. python -u benchmarks/nshard_memory.py [n ...]
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
from lcgp_tpu.parallel import nshard


def problem(n, q=8, p=16, d=4, seed=0):
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
    c = vg.lower(free).compile()
    ma = c.memory_analysis()
    return int(ma.temp_size_in_bytes)


def main():
    ns = [int(a) for a in sys.argv[1:]] or [512, 1024, 2048]
    mesh = nshard.make_n_mesh(8)
    rows = []
    for n in ns:
        data, free = problem(n)
        custom = temp_bytes(
            lambda fr: nshard.neglpost_full_nsharded(fr, data, mesh), free)
        plain = temp_bytes(
            lambda fr: nshard.neglpost_full_nsharded(fr, data, mesh,
                                                     _custom_vjp=False),
            free)
        single = temp_bytes(
            lambda fr: lik.neglpost_full(fr, data), free)
        row = dict(n=n, q=8,
                   nshard_custom_vjp_MB=round(custom / 1e6, 1),
                   nshard_plain_autodiff_MB=round(plain / 1e6, 1),
                   single_device_MB=round(single / 1e6, 1),
                   autodiff_vs_custom=round(plain / custom, 2))
        rows.append(row)
        print(json.dumps(row), flush=True)
    print(json.dumps({"table": rows}))


if __name__ == '__main__':
    main()
