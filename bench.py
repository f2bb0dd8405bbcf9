"""Headline benchmark (BASELINE.json north-star config).

Times NLL+gradient evaluations of the full-data loss at n=4096, p=1000,
q=20, d=8 on the default device, which must be a GPU, in float64 (the
reference's dtype — the conservative apples-to-apples number), float32 and
'mixed'.

Prints ONE JSON line:
  {"metric": ..., "value": evals/sec (f64), "unit": "evals/s",
   "vs_baseline": value / CPU-reference-equivalent evals/sec,
   "device": {"platform", "device_kind", "count", "card"}, ...extras}
with whatever sections completed; any failure adds "error" to that line
and exits non-zero.

The denominator comes from benchmarks/bench_baseline.json, measured once by
benchmarks/baseline_cpu.py (JAX-CPU jit of the reference's per-k eigh path;
see that file's methodology note — it is equal-or-faster than the real
TF/GPflow reference, so vs_baseline is conservative).
"""
from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

N, P_OUT, Q, D = 4096, 1000, 20, 8
RBAR = 10  # replicate count for the rep-path benchmark
WARMUP = 1
EVALS = 5

METRIC = 'nll_grad_evals_per_sec_n4096_p1000_q20_f64'


# Progressively filled by _run(): if a late section throws, the line still
# carries every number already measured instead of discarding a
# nearly-complete benchmark as 0.0.
PARTIAL: dict = {}


def _baseline() -> dict:
    base_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             'benchmarks', 'bench_baseline.json')
    if os.path.exists(base_path):
        with open(base_path) as f:
            return json.load(f)
    return {}


def _assemble(p: dict) -> dict:
    """Derive the JSON-line fields from whatever raw timings exist."""
    base = _baseline()
    base_evals = base.get('evals_per_sec_cpu')
    out = {'metric': METRIC, 'value': 0.0, 'unit': 'evals/s',
           'vs_baseline': 0.0, 'baseline_cpu_evals_per_sec': base_evals}

    def put(key, val):
        if val is not None:
            out[key] = val

    if p.get('secs64'):
        ev = 1.0 / p['secs64']
        out['value'] = round(ev, 4)
        out['secs_per_eval_f64'] = round(p['secs64'], 4)
        if base_evals:
            out['vs_baseline'] = round(ev / base_evals, 2)
    if p.get('secs32'):
        ev32 = 1.0 / p['secs32']
        out['evals_per_sec_f32'] = round(ev32, 4)
        out['secs_per_eval_f32'] = round(p['secs32'], 4)
        if base_evals:
            out['vs_baseline_f32'] = round(ev32 / base_evals, 2)
    if p.get('secs32_scan'):
        out['secs_per_eval_f32_scan'] = round(p['secs32_scan'], 4)
    if p.get('secs_mx'):
        out['evals_per_sec_mixed'] = round(1.0 / p['secs_mx'], 4)
        if base_evals:
            out['vs_baseline_mixed'] = round(
                (1.0 / p['secs_mx']) / base_evals, 2)
    put('q_chunk_f64', p.get('chunk64'))
    put('q_chunk_f32', p.get('chunk32'))
    if p.get('secs_rep64'):
        out['rep_secs_per_eval_f64'] = round(p['secs_rep64'], 4)
        out['rep_evals_per_sec_f64'] = round(1.0 / p['secs_rep64'], 4)
        if base.get('rep_evals_per_sec_cpu'):
            out['rep_vs_baseline_f64'] = round(
                (1.0 / p['secs_rep64']) / base['rep_evals_per_sec_cpu'], 2)
    if p.get('secs_rep32'):
        out['rep_secs_per_eval_f32'] = round(p['secs_rep32'], 4)
        if base.get('rep_evals_per_sec_cpu'):
            out['rep_vs_baseline_f32'] = round(
                (1.0 / p['secs_rep32']) / base['rep_evals_per_sec_cpu'], 2)
    if p.get('secs_rep_mx'):
        out['rep_secs_per_eval_mixed'] = round(p['secs_rep_mx'], 4)
        if base.get('rep_evals_per_sec_cpu'):
            out['rep_vs_baseline_mixed'] = round(
                (1.0 / p['secs_rep_mx']) / base['rep_evals_per_sec_cpu'], 2)
    put('rep_q_chunk_f64', p.get('chunk_rep64'))
    put('rep_q_chunk_f32', p.get('chunk_rep32'))
    put('predict_aux_secs_f64', p.get('aux64'))
    put('predict_aux_secs_mixed', p.get('aux_mx'))
    if p.get('aux64') and p.get('aux_mx'):
        out['predict_aux_speedup_mixed'] = round(p['aux64'] / p['aux_mx'], 2)
    put('predict_core_secs_256pts', p.get('pred_core'))
    put('device', p.get('device'))
    return out


def _degraded(error: str) -> None:
    """On failure still print ONE parseable JSON line — carrying any
    sections that completed before the failure."""
    out = _assemble(PARTIAL)
    out['error'] = error[:600]
    print(json.dumps(out))


def make_problem():
    import jax.numpy as jnp
    from lcgp_tpu.models import basis as basis_mod
    from lcgp_tpu.models import likelihood as lik
    from lcgp_tpu.models import params as P

    rng = np.random.default_rng(0)
    xs = rng.uniform(0, 1, (N, D))
    t = np.linspace(0, 1, P_OUT)[:, None]
    ys = (np.sin(2 * np.pi * (t + xs[:, :1].T)) +
          0.05 * rng.standard_normal((P_OUT, N)))
    ys = (ys - ys.mean(1, keepdims=True)) / ys.std(1, keepdims=True)
    b = basis_mod.init_phi(ys, q=Q)
    data = lik.FullData(xs=jnp.asarray(xs), ys=jnp.asarray(ys),
                        phi=jnp.asarray(b.phi), diag_D=jnp.asarray(b.diag_D),
                        sigma_map=jnp.asarray(P.sigma_index_map([1] * P_OUT)))
    free = P.init_values(xs, ys, Q, [1] * P_OUT)
    return data, free


def fuse_scalar(vg):
    """One fused on-device scalar (loss + sums of ALL grad leaves): forces
    the full value_and_grad — a gradient output nothing reads could be
    pruned or scheduled differently from what an optimizer pays for."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def fused(free, data):
        v, g = vg(free, data)
        return v + sum(jnp.sum(a, dtype=jnp.float64)
                       for a in jax.tree.leaves(g))
    return fused


def time_evals(vg, free, data):
    import jax
    fused = fuse_scalar(vg)

    for _ in range(WARMUP):
        jax.block_until_ready(fused(free, data))
    times = []
    for _ in range(EVALS):
        t0 = time.perf_counter()
        jax.block_until_ready(fused(free, data))
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def time_evals_scan(make_loss, free, data, k=8):
    """Amortized per-eval time: one dispatch scans k chained NLL-grad
    evals (a tiny param perturbation per step forces sequentiality so XLA
    cannot hoist the loop-invariant work).  This is what an on-device
    optimizer loop actually pays per eval — no per-eval dispatch RTT."""
    import jax
    import jax.numpy as jnp

    loss = make_loss()

    @jax.jit
    def run(free, data):
        def body(fr, _):
            v, g = jax.value_and_grad(loss)(fr, data)
            fr = jax.tree.map(lambda p, gg: p - 1e-12 * gg, fr, g)
            return fr, v
        fr, vs = jax.lax.scan(body, free, None, length=k)
        return jnp.sum(vs) + jnp.sum(fr.lLmb[0, :1])

    jax.block_until_ready(run(free, data))     # compile + warm
    t0 = time.perf_counter()
    jax.block_until_ready(run(free, data))
    return (time.perf_counter() - t0) / k


def _time_with_fallback(make_vg, free, data, chunks):
    """Time a value_and_grad variant; on device-memory exhaustion retry
    with a smaller q_chunk (identical math, smaller working set)."""
    import jax
    last = None
    for q_chunk in chunks:
        try:
            vg = make_vg(q_chunk)
            return time_evals(vg, free, data), q_chunk
        except Exception as e:  # noqa: BLE001
            msg = str(e)
            oom = 'RESOURCE_EXHAUSTED' in msg or 'memory' in msg.lower()
            if not oom:
                raise
            print(f'[bench] q_chunk={q_chunk} OOM, retrying smaller',
                  file=sys.stderr, flush=True)
            last = e
            jax.clear_caches()
    raise RuntimeError(f'OOM at every q_chunk in {chunks}: {last}')


def make_rep_problem():
    """Rep-submethod benchmark problem: n=4096 unique sites, rbar=10
    replicates, p=1000, q=20 — the reference's flagship large-N answer
    (reference lcgp.py:554-630), here in the Woodbury-free reformulated
    form (models/likelihood.py:304)."""
    import jax.numpy as jnp
    from lcgp_tpu.models import basis as basis_mod
    from lcgp_tpu.models import likelihood as lik
    from lcgp_tpu.models import params as P

    rng = np.random.default_rng(1)
    xs = rng.uniform(0, 1, (N, D))
    t = np.linspace(0, 1, P_OUT)[:, None]
    ybar = (np.sin(2 * np.pi * (t + xs[:, :1].T)) +
            0.05 / np.sqrt(RBAR) * rng.standard_normal((P_OUT, N)))
    ybar = (ybar - ybar.mean(1, keepdims=True)) / ybar.std(1, keepdims=True)
    r = np.full(N, float(RBAR))
    b = basis_mod.init_phi(ybar, q=Q)
    data = lik.RepData(xs=jnp.asarray(xs), ybar=jnp.asarray(ybar),
                       scale=jnp.ones(P_OUT), r=jnp.asarray(r),
                       phi=jnp.asarray(b.phi), diag_D=jnp.asarray(b.diag_D),
                       sigma_map=jnp.asarray(P.sigma_index_map([1] * P_OUT)))
    free = P.init_values(xs, ybar, Q, [1] * P_OUT)
    return data, free


def _run():
    import jax
    from lcgp_tpu.models import likelihood as lik

    data, free = make_problem()

    print(f'[bench] data dtype: {data.ys.dtype}', file=sys.stderr, flush=True)

    secs64, chunk64 = _time_with_fallback(
        lambda qc: jax.jit(lambda fr, d: jax.value_and_grad(
            lambda f_: lik.neglpost_full(f_, d, q_chunk=qc))(fr)),
        free, data, chunks=(5, 2))
    PARTIAL.update(secs64=secs64, chunk64=chunk64)

    secs32, chunk32 = _time_with_fallback(
        lambda qc: jax.jit(lambda fr, d: jax.value_and_grad(
            lambda f_: lik.neglpost_full(f_, d, compute_dtype=jax.numpy.float32,
                                         jitter=1e-6, q_chunk=qc))(fr)),
        free, data, chunks=(None, 10, 5))
    PARTIAL.update(secs32=secs32, chunk32=chunk32)

    # mixed: f64 data/Gram/reductions, f32-seeded refined factorizations
    # (f64-grade results in the validated conditioning regime)
    secs_mx, _chunk_mx = _time_with_fallback(
        lambda qc: jax.jit(lambda fr, d: jax.value_and_grad(
            lambda f_: lik.neglpost_full(f_, d, compute_dtype='mixed',
                                         q_chunk=qc))(fr)),
        free, data, chunks=(5, 2))
    PARTIAL['secs_mx'] = secs_mx

    # amortized (scan) f32 per-eval cost — what the on-device optimizer pays
    import jax.numpy as jnp_
    PARTIAL['secs32_scan'] = time_evals_scan(
        lambda: (lambda fr, d=data: lik.neglpost_full(
            fr, d, compute_dtype=jnp_.float32, jitter=1e-6,
            q_chunk=chunk32)), free, data)

    # rep path at scale: n=4096 unique x rbar=10
    # replicates (40,960 raw points collapsed), same p/q as the headline.
    rep_data, rep_free = make_rep_problem()
    secs_rep64, chunk_rep64 = _time_with_fallback(
        lambda qc: jax.jit(lambda fr, d: jax.value_and_grad(
            lambda f_: lik.neglpost_rep(f_, d, q_chunk=qc))(fr)),
        rep_free, rep_data, chunks=(5, 2))
    PARTIAL.update(secs_rep64=secs_rep64, chunk_rep64=chunk_rep64)
    secs_rep32, chunk_rep32 = _time_with_fallback(
        lambda qc: jax.jit(lambda fr, d: jax.value_and_grad(
            lambda f_: lik.neglpost_rep(f_, d,
                                        compute_dtype=jax.numpy.float32,
                                        jitter=1e-6, q_chunk=qc))(fr)),
        rep_free, rep_data, chunks=(None, 10, 5))
    PARTIAL.update(secs_rep32=secs_rep32, chunk_rep32=chunk_rep32)
    secs_rep_mx, _chunk_rep_mx = _time_with_fallback(
        lambda qc: jax.jit(lambda fr, d: jax.value_and_grad(
            lambda f_: lik.neglpost_rep(f_, d, compute_dtype='mixed',
                                        q_chunk=qc))(fr)),
        rep_free, rep_data, chunks=(5, 2))
    PARTIAL['secs_rep_mx'] = secs_rep_mx
    del rep_data, rep_free

    # Predict path: the f64-vs-mixed one-shot aux cost (the mixed aux
    # runs the refined factorization, models/lcgp.py _ensure_aux).
    _predict_section(free, data, chunk64 or 5)


def _predict_section(free, data, qc):
    """Time the one-shot predictive aux (f64 vs mixed) + 256-pt predict.

    Warmup compiles the one per-chunk executable by running a single
    chunk (all chunks share it: traced offset), so each full timing pays
    q/q_chunk dispatches of warm code."""
    import jax
    import jax.numpy as jnp
    from lcgp_tpu.models import predict as pred_mod

    def _aux_secs(cd):
        jax.block_until_ready(pred_mod._aux_full_chunk(
            free, data, 0, qc=qc, compute_dtype=cd, jitter=0.0,
            kernel='matern32'))                    # compile + warm
        t0 = time.perf_counter()
        aux = jax.block_until_ready(pred_mod.compute_aux_full(
            free, data, compute_dtype=cd, q_chunk=qc))
        return round(time.perf_counter() - t0, 4), aux

    PARTIAL['aux64'], aux = _aux_secs(None)
    PARTIAL['aux_mx'], _ = _aux_secs('mixed')

    x0s = jnp.asarray(np.random.default_rng(2).uniform(0, 1, (256, D)))

    def _pred_once():
        return jax.block_until_ready(pred_mod.predict_full_core(
            free, data, aux, x0s, q_chunk=qc))
    _pred_once()                                   # compile + warm
    t0 = time.perf_counter()
    _pred_once()
    PARTIAL['pred_core'] = round(time.perf_counter() - t0, 4)


def _device() -> dict:
    """The device the numbers are measured on; anything but a GPU is an
    error (a CPU number must never pass for a device number)."""
    import jax
    from lcgp_tpu.utils import gpu_card
    devs = jax.devices()
    if devs[0].platform != 'gpu':
        raise RuntimeError(f'first JAX device is {devs[0].platform!r}, '
                           'not a GPU')
    return dict(platform=devs[0].platform, device_kind=devs[0].device_kind,
                count=len(devs), card=gpu_card())


def main():
    try:
        PARTIAL['device'] = _device()
        _run()
    except Exception as e:  # noqa: BLE001 — one parseable line, then rc!=0
        import traceback
        traceback.print_exc(file=sys.stderr)
        _degraded(f'{type(e).__name__}: {e}')
        sys.exit(1)
    print(json.dumps(_assemble(PARTIAL)))


if __name__ == '__main__':
    main()
