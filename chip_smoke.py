"""Bring-up check: drive lcgp_tpu's user entry points on one NVIDIA GPU.

    python chip_smoke.py            # phases 1-5 on one GPU
    python chip_smoke.py --four     # only the four mesh modes, on 4 GPUs

Every phase goes through what a user calls — ``LCGP(...)``, ``fit``,
``predict``, ``save`` and ``PredictServer`` over HTTP — at the headline
width of BASELINE config 4 (n=4096 runs, d=8 inputs, p=1000 outputs, q=20
latents, float64), with data made from a seed.  Each phase compares what
comes out with an independent reference: the same loss on JAX's CPU
backend in the same process, the NumPy oracle (``tests/oracle.py``) at a
size the host can run, or the single-device result for the mesh modes.

Each phase prints one ``[phase] {json}`` line.  For every timed operation
(``ops``) it gives the warm seconds (the second identical call) and the
compile seconds (first call minus warm call: tracing, lowering and
compiling, or loading from the persistent cache).  It also gives the
device's ``peak_bytes_in_use`` (cumulative over the process, so it
isolates the first phase only) and every comparison as quantity /
tolerance / observed error.  The last line
is ``{"ok": true, "device": {...}}``.  Any error, tolerance miss or a first
device that is not a GPU exits non-zero without that line.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
import urllib.request

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

HEADLINE = dict(n=4096, d=8, p=1000, q=20)


class SmokeFailure(RuntimeError):
    pass


# ---------------------------------------------------------------------------
# Bookkeeping
# ---------------------------------------------------------------------------

def _peak_bytes():
    import jax
    peaks = [(d.memory_stats() or {}).get('peak_bytes_in_use')
             for d in jax.local_devices()]
    peaks = [p for p in peaks if p is not None]
    return max(peaks) if peaks else None


class Phase:
    """Collects one phase's timings and comparisons; every comparison
    that misses its tolerance raises after the phase line is printed."""

    def __init__(self, name):
        self.name = name
        self.checks = []
        self.ops = {}
        self.info = {}
        self._t0 = time.perf_counter()

    def op(self, name, fn, *args):
        """Run fn(*args) twice, synced: the second call is warm, the
        difference is what the first paid to trace and compile."""
        _, first = timed(fn, *args)
        out, warm = timed(fn, *args)
        self.ops[name] = dict(compile_s=round(max(first - warm, 0.0), 4),
                              warm_s=round(warm, 4))
        return out

    def compare(self, quantity, err, tol):
        err = float(err)
        self.checks.append(dict(quantity=quantity, tol=tol, err=err,
                                ok=bool(np.isfinite(err) and err <= tol)))

    def require(self, quantity, cond):
        self.checks.append(dict(quantity=quantity, ok=bool(cond)))

    def finish(self):
        rec = dict(name=self.name,
                   compile_s=round(sum(o['compile_s']
                                       for o in self.ops.values()), 4),
                   wall_s=round(time.perf_counter() - self._t0, 3),
                   peak_bytes=_peak_bytes(), ops=self.ops, **self.info,
                   checks=self.checks)
        print('[phase] ' + json.dumps(rec), flush=True)
        bad = [c['quantity'] for c in self.checks if not c['ok']]
        if bad:
            raise SmokeFailure(f'phase {self.name}: failed {bad}')
        return rec


def rel_err(a, b):
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def tree_rel_err(g, g_ref):
    """Largest per-leaf max-abs error over the leaf's max magnitude."""
    import jax
    return max(rel_err(a, b) for a, b in zip(jax.tree.leaves(g),
                                             jax.tree.leaves(g_ref)))


def timed(fn, *args, **kw):
    import jax
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args, **kw))
    return out, time.perf_counter() - t0


# ---------------------------------------------------------------------------
# Data (made from a seed, as bench.make_problem / make_rep_problem do)
# ---------------------------------------------------------------------------

def make_field(n, d, p, seed):
    """(x (n, d), y (p, n)): a smooth field over p output locations that
    moves with the first input, plus noise."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (n, d))
    t = np.linspace(0, 1, p)[:, None]
    y = (np.sin(2 * np.pi * (t + x[:, :1].T))
         + 0.5 * np.cos(np.pi * t * x[:, 1:2].T)
         + 0.05 * rng.standard_normal((p, n)))
    return x, y


def make_rep_field(n_unique, reps, d, p, seed):
    """n_unique sites, each run ``reps`` times: (x (n_unique*reps, d),
    y (p, n_unique*reps)) with independent noise per run."""
    rng = np.random.default_rng(seed)
    xu = rng.uniform(0, 1, (n_unique, d))
    x = np.repeat(xu, reps, axis=0)
    t = np.linspace(0, 1, p)[:, None]
    y = (np.sin(2 * np.pi * (t + x[:, :1].T))
         + 0.5 * np.cos(np.pi * t * x[:, 1:2].T)
         + 0.2 * rng.standard_normal((p, x.shape[0])))
    return x, y


# ---------------------------------------------------------------------------
# References
# ---------------------------------------------------------------------------

def loss_on_cpu(model, free=None):
    """The model's own loss at ``free`` on JAX's CPU backend, with every
    matmul at full precision.  Both sides are IEEE f64, so the two
    backends differ only in summation order."""
    import jax
    from lcgp_tpu.fit.auxloss import AuxLoss
    cpu = jax.devices('cpu')[0]
    free = model._free if free is None else free
    z = model._z
    if z is not None:              # the FITC loss closes over the inducing set
        model._z = jax.device_put(z, cpu)
    try:
        loss = model._loss_fn()
        fn = loss.fn if isinstance(loss, AuxLoss) else (lambda f, _d: loss(f))
        aux = loss.aux if isinstance(loss, AuxLoss) else None
        with jax.default_matmul_precision('highest'):
            return float(fn(jax.device_put(free, cpu),
                            jax.device_put(aux, cpu)))
    finally:
        model._z = z


def loss_and_grad(model):
    """A jitted loss+grad of the model's own loss (its precision, chunking
    and kernel) at its current parameters, as a no-argument callable."""
    import jax
    from lcgp_tpu.fit.auxloss import split_aux
    fn, aux = split_aux(model._loss_fn())
    vg = jax.jit(jax.value_and_grad(fn))
    free = model._free
    return lambda: vg(free, aux)


def oracle_loss_and_predict(model, x0):
    """tests/oracle.py's NumPy f64 loss and predictions for a full model."""
    sys.path.insert(0, os.path.join(ROOT, 'tests'))
    import oracle
    from lcgp_tpu.models import params as P
    lLmb, lLmb0, lsig, lnug = (np.asarray(a) for a in P.constrain(model._free))
    args = (lLmb, lLmb0, lsig, lnug, np.asarray(model.x), np.asarray(model.y),
            np.asarray(model.phi), np.asarray(model.diag_D),
            model.diag_error_structure)
    loss = oracle.neglpost_full_np(*args)
    x0s = np.asarray(model._standardize_x0(x0))
    pred = oracle.predict_full_np(*args, np.asarray(model.ymean),
                                  np.asarray(model.ystd), x0s)
    return loss, pred


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def phase_full(n, d, p, q, n0=256, n_oracle=1024, maxiter=3, seed=0):
    """Phase 1: LCGP(y, x, q) with the planner's own q_chunk, a few scipy
    L-BFGS iterations, predict; cross-checked against the CPU backend at
    full size and the NumPy oracle at n_oracle."""
    from lcgp_tpu import LCGP

    ph = Phase('full_high')
    x, y = make_field(n, d, p, seed)
    model = LCGP(y, x, q=q)
    qc = model.q_chunk
    ph.info.update(n=n, d=d, p=p, q=q, q_chunk=qc,
                   planner_budget_bytes=LCGP._hbm_budget_bytes(),
                   planner_peak_bytes=LCGP._q_peak_bytes(q, qc or q, n,
                                                         'high'))

    l0 = float(model.loss())
    l0_cpu = loss_on_cpu(model)
    # same f64 arithmetic on two backends: only summation order differs
    ph.compare('loss@init vs CPU backend (rel)', abs(l0 - l0_cpu) /
               abs(l0_cpu), 1e-9)

    t0 = time.perf_counter()
    model.fit(method='scipy', maxiter=maxiter)
    fit_s = time.perf_counter() - t0
    res = model._fit_result
    ph.info['peak_bytes_after_fit'] = _peak_bytes()
    l1 = float(res.fun)
    ph.require('fitted loss finite', np.isfinite(l1))
    ph.require('fitted loss <= initial loss', l1 <= l0)
    ph.info.update(loss_init=l0, loss_fit=l1, nfev=int(res.nfev),
                   nit=int(res.nit), fit_s=round(fit_s, 3))
    ph.op('loss+grad', loss_and_grad(model))

    x0 = np.random.default_rng(seed + 1).uniform(0, 1, (n0, d))
    out = ph.op(f'predict {n0}', model.predict, x0)
    ph.require(f'predict shapes ({p}, {n0})',
               all(o.shape == (p, n0) for o in out))
    ph.require('predictions finite',
               all(np.isfinite(np.asarray(o)).all() for o in out))

    # The oracle's per-component eigh is host-bound: compare at n_oracle
    # with every other width unchanged.
    xo, yo = x[:n_oracle], y[:, :n_oracle]
    small = LCGP(yo, xo, q=q)
    lo_ref, pred_ref = oracle_loss_and_predict(small, x0)
    ph.compare(f'loss@init vs NumPy oracle at n={n_oracle} (rel)',
               abs(float(small.loss()) - lo_ref) / abs(lo_ref), 1e-9)
    got = [np.asarray(o) for o in small.predict(x0)]
    # BASELINE's parity target for predictions
    for name, g, r in zip(('ypred', 'ypredvar', 'yconfvar'), got, pred_ref):
        ph.compare(f'{name} vs NumPy oracle at n={n_oracle} (max rel)',
                   float(np.max(np.abs(g - r) / np.abs(r))), 1e-6)
    del small
    ph.finish()
    return model, x0, dict(loss_init=l0)


def probe_matmul_precision(n=4096, seed=0):
    """What XLA runs for an f32 matmul at each lax.Precision on this
    device, read from the error against the f64 product: ~1e-7 is true
    f32, ~1e-6 bf16_3x, ~1e-4 TF32 or one bf16 pass."""
    import jax
    import jax.numpy as jnp
    from jax import lax
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n))
    b = rng.standard_normal((n, n))
    ref = a @ b
    a32, b32 = jnp.asarray(a, jnp.float32), jnp.asarray(b, jnp.float32)
    out = {}
    for name, prec in (('DEFAULT', lax.Precision.DEFAULT),
                       ('HIGH', lax.Precision.HIGH),
                       ('HIGHEST', lax.Precision.HIGHEST)):
        mm = jax.jit(lambda u, v, pr=prec: jnp.matmul(u, v, precision=pr))
        got = np.asarray(mm(a32, b32), dtype=np.float64)
        out[name] = float(np.linalg.norm(got - ref) / np.linalg.norm(ref))
    return out


def phase_precisions(n, d, p, q, f64_loss_init, seed=0,
                     fast_loss_tol=1e-6, fast_grad_tol=1e-5):
    """Phase 2: one loss+grad at precision 'mixed' and 'fast', against the
    f64 loss and gradient at the same (initial) parameters."""
    import jax
    from lcgp_tpu import LCGP
    from lcgp_tpu.ops import linalg

    ph = Phase('precisions')
    x, y = make_field(n, d, p, seed)

    def run(precision, label=None):
        m = LCGP(y, x, q=q, precision=precision)
        if precision == 'mixed':
            m._sync_refine_steps()
        v, g = ph.op(f'loss+grad {label or precision}', loss_and_grad(m))
        return float(v), g, m.q_chunk

    v64, g64, qc64 = run('high')
    vmx, gmx, qcmx = run('mixed')
    vf, gf, qcf = run('fast')
    # mixed's documented contract: f64-grade loss (ops/mixed.py refinement)
    ph.compare('mixed loss vs f64 (rel)', abs(vmx - v64) / abs(v64), 1e-8)
    ph.compare('phase-1 f64 loss reproduced (rel)',
               abs(v64 - f64_loss_init) / abs(f64_loss_init), 1e-12)
    # fast: f32 Gram + factorization with a 1e-6 jitter floor.  The loss
    # error is set by the jitter and f32 rounding of the logdet/quad terms
    # (5e-8 measured on an H100); the gradient's by the f32 inverse
    # assembly (ops/linalg.chol_inverse): 1.5e-6 measured with true-f32
    # GEMMs, 2.5e-5 when they ran in TF32 — so 1e-5 catches TF32 creeping
    # into the gradient path.
    ph.compare('fast loss vs f64 (rel)', abs(vf - v64) / abs(v64),
               fast_loss_tol)
    ph.compare('fast grad vs f64 (max rel per leaf)', tree_rel_err(gf, g64),
               fast_grad_tol)
    ph.info.update(q_chunk=dict(high=qc64, mixed=qcmx, fast=qcf),
                   mixed_grad_rel_err=tree_rel_err(gmx, g64),
                   matmul_f32_rel_err=probe_matmul_precision())
    # the fast gradient with the inverse-combination GEMMs at
    # Precision.HIGH (TF32 on an H100), the setting _INV_GEMM_PRECISION
    # replaced: its error is reported, not bounded
    saved = linalg._INV_GEMM_PRECISION
    linalg._INV_GEMM_PRECISION = jax.lax.Precision.HIGH
    jax.clear_caches()
    try:
        _, g_high, _ = run('fast', 'fast inverse GEMMs HIGH')
    finally:
        linalg._INV_GEMM_PRECISION = saved
        jax.clear_caches()
    ph.info['fast_grad_rel_err_inverse_gemms_HIGH'] = tree_rel_err(g_high,
                                                                   g64)
    ph.finish()


def phase_rep(n_unique, reps, d, p, q, n0=256, maxiter=3, seed=1):
    """Phase 3: submethod='rep' on n_unique sites x reps replicates,
    grouped on the host by the constructor."""
    from lcgp_tpu import LCGP

    ph = Phase('rep_high')
    x, y = make_rep_field(n_unique, reps, d, p, seed)
    model = LCGP(y, x, q=q, submethod='rep')
    ph.info.update(raw_rows=int(x.shape[0]), n_unique=int(model.n), p=p,
                   q=q, q_chunk=model.q_chunk)
    ph.require(f'grouped to {n_unique} unique sites', model.n == n_unique)
    l0 = float(model.loss())
    l0_cpu = loss_on_cpu(model)
    ph.compare('rep loss@init vs CPU backend (rel)',
               abs(l0 - l0_cpu) / abs(l0_cpu), 1e-9)
    t0 = time.perf_counter()
    model.fit(method='scipy', maxiter=maxiter)
    fit_s = time.perf_counter() - t0
    res = model._fit_result
    l1 = float(res.fun)
    ph.require('fitted loss finite', np.isfinite(l1))
    ph.require('fitted loss <= initial loss', l1 <= l0)
    ph.op('loss+grad', loss_and_grad(model))
    x0 = np.random.default_rng(seed + 1).uniform(0, 1, (n0, d))
    out = [np.asarray(o) for o in ph.op(f'predict {n0}', model.predict, x0)]
    ph.require(f'predict shapes ({p}, {n0})',
               all(o.shape == (p, n0) for o in out))
    ph.require('predictions finite', all(np.isfinite(o).all() for o in out))
    ph.info.update(loss_init=l0, loss_fit=l1, nfev=int(res.nfev),
                   fit_s=round(fit_s, 3))
    ph.finish()


def phase_fitc(n, d, p, q, m, n_check, steps=10, n0=256, seed=2):
    """Phase 4: FITC (inducing=m) at n, a few Adam steps, predict; the loss
    cross-checked against the CPU backend at n_check."""
    from lcgp_tpu import LCGP

    ph = Phase('fitc')
    x, y = make_field(n, d, p, seed)
    model = LCGP(y, x, q=q, inducing=m)
    ph.info.update(n=n, d=d, p=p, q=q, m=m, n_chunk=model.n_chunk)
    l0 = float(model.loss())
    t0 = time.perf_counter()
    model.fit(method='adam', steps=steps, learning_rate=1e-2)
    fit_s = time.perf_counter() - t0
    l1 = float(model.loss())
    ph.require('loss finite after Adam', np.isfinite(l1))
    ph.require('loss fell under Adam', l1 < l0)
    ph.op('loss+grad', loss_and_grad(model))
    x0 = np.random.default_rng(seed + 1).uniform(0, 1, (n0, d))
    out = [np.asarray(o) for o in ph.op(f'predict {n0}', model.predict, x0)]
    ph.require(f'predict shapes ({p}, {n0})',
               all(o.shape == (p, n0) for o in out))
    ph.require('predictions finite', all(np.isfinite(o).all() for o in out))
    small = LCGP(y[:, :n_check], x[:n_check], q=q, inducing=m)
    ls = float(small.loss())
    ls_cpu = loss_on_cpu(small)
    ph.compare(f'FITC loss@init vs CPU backend at n={n_check} (rel)',
               abs(ls - ls_cpu) / abs(ls_cpu), 1e-9)
    ph.info.update(loss_init=l0, loss_fit=l1, fit_s=round(fit_s, 3))
    ph.finish()


def _post(url, payload, timeout=600):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={'Content-Type': 'application/json'})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def phase_serve(model, sizes=(1, 17, 256, 600), batch_size=256, seed=3):
    """Phase 5: save the phase-1 model, serve it over HTTP on 127.0.0.1,
    answer requests of several sizes, hot-reload a same-shape refit and
    answer once more."""
    from lcgp_tpu import LCGP
    from lcgp_tpu.models import params as P
    from lcgp_tpu.serve import PredictServer

    ph = Phase('serve')
    d = int(model.d)
    rng = np.random.default_rng(seed)
    with tempfile.TemporaryDirectory(dir=ROOT, prefix='.chip_smoke_') as tmp:
        path = os.path.join(tmp, 'model.npz')
        model.save(path)
        t0 = time.perf_counter()
        server = PredictServer(path, batch_size=batch_size, reload_dir=tmp)
        # construction loads the model, builds its predictive state and
        # compiles the fixed-batch executable (warmup)
        ph.ops['server start'] = dict(
            compile_s=round(time.perf_counter() - t0, 4), warm_s=None)
        try:
            httpd, _ = server.serve(host='127.0.0.1', port=0,
                                    background=True)
            url = f'http://127.0.0.1:{httpd.server_address[1]}'
            ref_model = LCGP.load(path)
            lat = {}

            def ask(k, ref):
                x0 = rng.uniform(0, 1, (k, d))
                t = time.perf_counter()
                out = _post(url + '/predict', {'x': x0.tolist()})
                lat[k] = round(time.perf_counter() - t, 4)
                want = [np.asarray(o) for o in ref.predict(x0)]
                for name, w in zip(('ypred', 'ypredvar', 'yconfvar'), want):
                    ph.compare(f'{name} n0={k} served vs model.predict '
                               '(max rel)',
                               rel_err(np.asarray(out[name]), w), 1e-10)

            for k in sizes:
                ask(k, ref_model)
            # same-shape refit: perturbed parameters, same data and config
            lLmb, lLmb0, lsig, lnug = P.constrain(ref_model._free)
            ref_model.set_params(lLmb0=lLmb0 * 1.1)
            path2 = os.path.join(tmp, 'model2.npz')
            ref_model.save(path2)
            info = _post(url + '/reload', {'path': 'model2.npz'})
            ph.require('reload reused the compiled executable',
                       info.get('reused_executable') is True)
            ph.info['reload_warmup_s'] = info.get('warmup_secs')
            ask(sizes[-1], LCGP.load(path2))
            ph.info['request_latency_s'] = lat
        finally:
            server.shutdown()
    ph.finish()


# ---------------------------------------------------------------------------
# --four: the mesh modes on four devices, each against one device
# ---------------------------------------------------------------------------

def phase_four_comp_out(n, d, p, q, devices, seed=0):
    """('comp','out') mesh: value_and_grad at the given width, against the
    single-device loss+grad with the planner's q_chunk."""
    import jax
    from lcgp_tpu import LCGP, parallel
    from lcgp_tpu.models import likelihood as lik

    ph = Phase('four_comp_out')
    x, y = make_field(n, d, p, seed)
    model = LCGP(y, x, q=q)
    n_comp, n_out = 2, len(devices) // 2
    mesh = parallel.make_mesh(n_comp=n_comp, n_out=n_out, devices=devices)
    vg = parallel.make_sharded_value_and_grad(mesh, model._data)
    args = (parallel.place(model._free, parallel.param_shardings(mesh)),
            parallel.place(model._data,
                           parallel.data_shardings(mesh, model._data)))
    v, g = ph.op('sharded loss+grad', vg, *args)
    free0, data0 = jax.device_put((model._free, model._data), devices[0])
    ref = jax.jit(jax.value_and_grad(
        lambda f, dd: lik.neglpost_full(f, dd, q_chunk=model.q_chunk)))
    v0, g0 = ph.op('single-device loss+grad', ref, free0, data0)
    _compare_loss_grad(ph, v, g, v0, g0)
    ph.info.update(mesh=f'comp={n_comp} x out={n_out}', n=n, p=p, q=q)
    ph.finish()


def _compare_loss_grad(ph, v, g, v0, g0):
    ph.compare('loss vs single device (rel)',
               abs(float(v) - float(v0)) / abs(float(v0)), 1e-8)
    ph.compare('grad vs single device (max rel per leaf)',
               tree_rel_err(g, g0), 1e-7)


def phase_four_nshard(n, d, p, q, devices, n0=256, steps=2, seed=4):
    """('n',) mesh and the 2x2 ('comp','n') mesh: exact loss+grad, plus a
    fit+predict on ('n',), against one device with q_chunk=1."""
    import jax
    from lcgp_tpu import LCGP
    from lcgp_tpu.models import likelihood as lik
    from lcgp_tpu.parallel import nshard

    ph = Phase('four_n')
    x, y = make_field(n, d, p, seed)
    model = LCGP(y, x, q=q, q_chunk=1)
    dev0 = devices[0]
    free0, data0 = jax.device_put((model._free, model._data), dev0)
    v0, g0 = ph.op('single-device loss+grad', jax.jit(jax.value_and_grad(
        lambda f, dd: lik.neglpost_full(f, dd, q_chunk=1))), free0, data0)
    nmesh = nshard.make_n_mesh(devices=devices)
    vg = nshard.make_nsharded_value_and_grad(nmesh, model._data)
    v, g = ph.op('n-sharded loss+grad', vg, model._free)
    _compare_loss_grad(ph, v, g, v0, g0)
    fitted = LCGP(y, x, q=q)
    fitted.fit(mesh=nmesh, method='adam', steps=steps, learning_rate=1e-2)
    x0 = np.random.default_rng(seed + 1).uniform(0, 1, (n0, d))
    yp = np.asarray(fitted.predict(x0)[0])
    single = LCGP(y, x, q=q, q_chunk=1)
    single._free = jax.device_put(fitted._free, dev0)
    single._params_version += 1
    ph.compare('fit+predict ypred vs single device (max rel)',
               rel_err(yp, np.asarray(single.predict(x0)[0])), 1e-8)
    ph.info.update(mesh=f'n={len(devices)}', n=n, p=p, q=q)
    ph.finish()

    ph = Phase('four_comp_n')
    ncmesh = nshard.make_nc_mesh(2, len(devices) // 2, devices=devices)
    vg = nshard.make_nsharded_value_and_grad(ncmesh, model._data)
    v, g = ph.op('comp x n-sharded loss+grad', vg, model._free)
    _compare_loss_grad(ph, v, g, v0, g0)
    ph.info.update(mesh=f'comp=2 x n={len(devices) // 2}', n=n, p=p, q=q)
    ph.finish()


def phase_four_fitc(n, d, p, q, m, devices, n0=256, steps=2, seed=5):
    """FITC on the ('n',) mesh: loss+grad and a fit+predict against one
    device."""
    import jax
    from lcgp_tpu import LCGP
    from lcgp_tpu.models import sparse
    from lcgp_tpu.parallel import fitc_shard, nshard

    ph = Phase('four_fitc')
    x, y = make_field(n, d, p, seed)
    model = LCGP(y, x, q=q, inducing=m)
    nmesh = nshard.make_n_mesh(devices=devices)
    dev0 = devices[0]
    free0, data0, z0 = jax.device_put((model._free, model._data, model._z),
                                      dev0)
    v0, g0 = ph.op('single-device loss+grad', jax.jit(jax.value_and_grad(
        lambda f, dd, z: sparse.neglpost_full_fitc(
            f, dd, z, n_chunk=model.n_chunk))), free0, data0, z0)
    vg = jax.jit(jax.value_and_grad(
        lambda f, dd, z: fitc_shard.neglpost_full_fitc_nsharded(
            f, dd, z, nmesh)))
    data_sh = jax.device_put(model._data,
                             nshard.data_shardings(nmesh, model._data))
    v, g = ph.op('n-sharded loss+grad', vg, model._free, data_sh, model._z)
    _compare_loss_grad(ph, v, g, v0, g0)
    fitted = LCGP(y, x, q=q, inducing=m)
    fitted.fit(mesh=nmesh, method='adam', steps=steps, learning_rate=1e-2)
    x0 = np.random.default_rng(seed + 1).uniform(0, 1, (n0, d))
    yp = np.asarray(fitted.predict(x0)[0])
    single = LCGP(y, x, q=q, inducing=m)
    single._free, single._z = jax.device_put((fitted._free, fitted._z), dev0)
    single._params_version += 1
    ph.compare('fit+predict ypred vs single device (max rel)',
               rel_err(yp, np.asarray(single.predict(x0)[0])), 1e-8)
    ph.info.update(mesh=f'n={len(devices)}', n=n, p=p, q=q, m=m,
                   n_chunk=model.n_chunk)
    ph.finish()


# ---------------------------------------------------------------------------

def _ensure_cpu_backend():
    """The CPU references need JAX's CPU backend beside the GPU one; a
    JAX_PLATFORMS that names only the GPU gets ',cpu' appended (the GPU
    stays first, so it stays the default device)."""
    plats = os.environ.get('JAX_PLATFORMS', '')
    if plats and 'cpu' not in plats.split(','):
        import jax
        jax.config.update('jax_platforms', plats + ',cpu')


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--four', action='store_true',
                    help='run only the four mesh modes, on 4 GPUs')
    args = ap.parse_args(argv)

    from lcgp_tpu.utils import gpu_card   # x64, matmul precision, cache

    print(f'[card] {gpu_card()}', flush=True)
    _ensure_cpu_backend()
    import jax

    devs = jax.devices()
    if devs[0].platform != 'gpu':
        raise SmokeFailure(f'first JAX device is {devs[0].platform!r}, '
                           'not a GPU')
    print(f'[device] {devs[0].device_kind} x{len(devs)}; '
          f'compile cache {jax.config.jax_compilation_cache_dir}', flush=True)

    h = HEADLINE
    if args.four:
        if len(devs) < 4:
            raise SmokeFailure(f'--four needs 4 GPUs, found {len(devs)}')
        four = devs[:4]
        phase_four_comp_out(h['n'], h['d'], h['p'], h['q'], four)
        phase_four_nshard(16384, h['d'], 64, 4, four)
        phase_four_fitc(200_000, h['d'], 100, 5, 512, four)
        count = 4
    else:
        model, _, ref = phase_full(h['n'], h['d'], h['p'], h['q'])
        phase_precisions(h['n'], h['d'], h['p'], h['q'], ref['loss_init'])
        phase_rep(h['n'], 10, h['d'], h['p'], h['q'])
        phase_fitc(50_000, h['d'], 100, 5, 512, n_check=5_000)
        phase_serve(model)
        count = 1
    print(json.dumps({'ok': True, 'device': {
        'platform': devs[0].platform, 'kind': devs[0].device_kind,
        'count': count}}), flush=True)


if __name__ == '__main__':
    try:
        main()
    except Exception as e:  # noqa: BLE001 — any failure: no result line
        import traceback
        traceback.print_exc()
        print(f'[chip_smoke] FAILED: {type(e).__name__}: {e}',
              file=sys.stderr, flush=True)
        sys.exit(1)
