"""Fully on-device optimization loops.

The reference has no equivalent — its optimizer runs eagerly on the host.
These loops keep the optimization inside jitted ``lax.scan`` segments.

The loops run in ``block_steps``-sized jitted segments with a scalar host
sync between segments: same math, and the sync points are where progress
reporting, user callbacks (mid-fit checkpointing) and the plateau stop
run.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np

import jax
import jax.numpy as jnp
import optax

from .auxloss import split_aux


class DeviceFitResult(NamedTuple):
    params: object
    fun: jnp.ndarray
    nit: jnp.ndarray
    stop_reason: str = 'cap'   # 'gtol' | 'plateau' | 'cap'


class PlateauTracker:
    """The one early-stop rule shared by every host-synced block loop
    (here and parallel/mesh.fit_sharded): stop once the best loss so far
    has failed to improve by ``rtol`` (relative) for ``patience``
    consecutive syncs.  ``rtol=None`` disables.  L-BFGS's line-searched
    loss is monotone, so patience=1 suffices there; non-monotone Adam
    loops need patience>1 so transient oscillation cannot truncate a fit.
    """

    def __init__(self, rtol, patience: int = 1):
        self.rtol = rtol
        self.patience = patience
        self.best = np.inf
        self.stale = 0

    def update(self, v: float) -> bool:
        """Feed one synced loss value; True means stop on plateau."""
        if self.rtol is None or not np.isfinite(v):
            return False
        if (self.best - v) / max(1.0, abs(v)) < self.rtol:
            self.stale += 1
            if self.stale >= self.patience:
                return True
        else:
            self.stale = 0
        self.best = min(self.best, v)
        return False


def minimize_adam(loss_fn: Callable, params0, *, steps: int = 500,
                  learning_rate: float = 5e-2, block_steps: int = 50,
                  verbose: bool = False,
                  callback: Callable = None) -> DeviceFitResult:
    """callback(step, loss, params), invoked at each host sync (block
    boundary) — use for mid-fit checkpointing/telemetry."""
    opt = optax.adam(learning_rate)
    # aux (training tensors) rides as a runtime jit argument, not a traced
    # closure constant — see fit/auxloss.py for why
    fn, aux = split_aux(loss_fn)
    vg = jax.value_and_grad(fn)

    def make_block(length):
        @jax.jit
        def run_block(params, state, aux):
            def body(carry, _):
                params, state = carry
                v, g = vg(params, aux)
                updates, state = opt.update(g, state, params)
                params = optax.apply_updates(params, updates)
                return (params, state), v

            (params, state), losses = jax.lax.scan(body, (params, state),
                                                   None, length=length)
            return params, state, losses[-1]
        return run_block

    state = jax.jit(opt.init)(params0)
    params = params0
    run_full = make_block(min(block_steps, steps))
    done = 0
    last = None
    while done < steps:
        length = min(block_steps, steps - done)
        block = run_full if length == min(block_steps, steps) else \
            make_block(length)
        params, state, v = block(params, state, aux)
        last = float(v)  # host sync: progress, callback, checkpoint
        done += length
        if verbose:
            print(f'[lcgp_tpu.fit adam] step {done:4d}  loss {last:.8g}')
        if callback is not None:
            callback(done, last, params)
    # Adam's step count is a budget, not a convergence criterion — 'steps'
    # (vs 'cap') keeps fit() from announcing a premature-stop warning.
    return DeviceFitResult(params=params, fun=jnp.asarray(last),
                           nit=jnp.asarray(steps), stop_reason='steps')


def minimize_lbfgs_jax(loss_fn: Callable, params0, *, maxiter: int = 500,
                       tol: float = 1e-9, block_iters: int = 25,
                       linesearch: str = 'zoom',
                       verbose: bool = False,
                       plateau_rtol: float = None,
                       callback: Callable = None) -> DeviceFitResult:
    """On-device optax L-BFGS.

    linesearch='zoom' (optax default; robust, ~3-8 loss evals per
    iteration) or 'backtracking' (1-2 evals per iteration — cheaper per
    step on accelerators where each eval is a full factorization pass).
    callback(step, loss, params) runs at each host sync (block boundary).
    plateau_rtol: if set, stop when the relative loss decrease over the
    last ``block_iters`` iterations falls below it (checked at block
    boundaries — free, the host syncs there anyway).  ``stop_reason``
    records why optimization ended ('gtol'/'plateau'/'cap').
    """
    if linesearch == 'backtracking':
        opt = optax.lbfgs(
            linesearch=optax.scale_by_backtracking_linesearch(
                max_backtracking_steps=20, store_grad=True))
    else:
        opt = optax.lbfgs()
    # aux (training tensors) rides as a runtime jit argument, not a traced
    # closure constant — see fit/auxloss.py for why
    fn, aux = split_aux(loss_fn)

    @jax.jit
    def run_block(params, state, it, aux):
        loss_p = lambda p: fn(p, aux)       # binds the *traced* aux
        vg = optax.value_and_grad_from_state(loss_p)

        def cond(carry):
            params, state, i = carry
            grad = optax.tree.get(state, "grad")
            gnorm = optax.global_norm(grad)
            within = jnp.logical_or(i == 0, gnorm > tol)
            return jnp.logical_and(i < it + block_iters,
                                   jnp.logical_and(i < maxiter, within))

        def body(carry):
            params, state, i = carry
            value, grad = vg(params, state=state)
            updates, state = opt.update(grad, state, params, value=value,
                                        grad=grad, value_fn=loss_p)
            params = optax.apply_updates(params, updates)
            return params, state, i + 1

        params, state, i = jax.lax.while_loop(cond, body, (params, state, it))
        return params, state, i, optax.tree.get(state, "value")

    params = params0
    state = jax.jit(opt.init)(params0)
    it = jnp.asarray(0)
    value = jnp.asarray(jnp.inf)
    plateau = PlateauTracker(plateau_rtol)
    reason = 'cap'
    while True:
        params, state, it_new, value = run_block(params, state, it, aux)
        done = int(it_new)  # host sync
        v = float(value)
        if verbose:
            print(f'[lcgp_tpu.fit lbfgs-jax] iter {done:4d}  '
                  f'loss {v:.8g}')
        if callback is not None:
            callback(done, v, params)
        if done == int(it):
            reason = 'gtol'      # while_loop exited on gnorm, not budget
            it = it_new
            break
        if plateau.update(v):
            reason = 'plateau'
            it = it_new
            break
        if done >= maxiter:
            reason = 'cap'
            it = it_new
            break
        it = it_new
    return DeviceFitResult(params=params, fun=value, nit=it,
                           stop_reason=reason)
