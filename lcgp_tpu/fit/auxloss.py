"""Loss wrapper that keeps big data tensors out of jitted closures.

A loss built as ``lambda free: neglpost(free, data)`` embeds ``data`` in
the traced jaxpr as *constants*, which XLA inlines into the compiled
program: at streaming-FITC scale (n=2M -> ~0.4 GB of training tensors)
every executable, and every persistent-cache entry, carries a copy, and
new data with the same shapes recompiles.  ``AuxLoss`` keeps the loss a
pure function of ``(params, aux)`` so optimizers can thread ``aux``
through their jitted blocks as a runtime argument — transferred to the
device once, never baked into the program.

Host-eager callers can still treat an ``AuxLoss`` as a plain closure:
``loss(params)`` binds the stored aux (fine at small scale, e.g. the
validation harnesses' direct ``jax.grad`` probes).
"""
from __future__ import annotations

from typing import Callable

import jax


class AuxLoss:
    """``fn(params, aux)`` + the aux pytree, callable as ``loss(params)``.

    ``aux_sharding`` (optional) is a pytree of :class:`jax.sharding.Sharding`
    matching ``aux`` (``None`` leaves = default placement).  Mesh losses
    (parallel/nshard, parallel/fitc_shard) attach it so :func:`split_aux`
    stages each data leaf directly with its mesh layout — without it the
    whole pytree lands on one device and is resharded inside every dispatch,
    which at pod-scale n can OOM the staging chip.
    """

    def __init__(self, fn: Callable, aux, aux_sharding=None):
        self.fn = fn
        self.aux = aux
        self.aux_sharding = aux_sharding

    def __call__(self, params):
        return self.fn(params, self.aux)


def split_aux(loss_fn):
    """Normalize any loss to the ``(fn(params, aux), aux)`` form.

    For an :class:`AuxLoss` the aux pytree is also ``device_put`` once so
    repeated jitted-block calls pass committed device arrays (no per-call
    host->device transfer), honoring ``aux_sharding`` when present.  A plain
    closure gets ``aux=None`` (an empty pytree — free to thread through jit).
    """
    if isinstance(loss_fn, AuxLoss):
        # leave committed jax.Arrays alone (they may carry a sharding);
        # only host arrays need the one-time transfer
        def put(a, s):
            if isinstance(a, jax.Array) and (s is None or a.sharding == s):
                return a
            return jax.device_put(a, s) if s is not None else jax.device_put(a)
        if loss_fn.aux_sharding is not None:
            # flatten explicitly: None leaves in the sharding tree mean
            # "default placement" and must not vanish under tree.map
            flat, treedef = jax.tree.flatten(loss_fn.aux)
            sh_flat = jax.tree.flatten(loss_fn.aux_sharding,
                                       is_leaf=lambda x: x is None)[0]
            if len(sh_flat) != len(flat):
                raise ValueError('aux_sharding structure does not match aux')
            aux = jax.tree.unflatten(
                treedef, [put(a, s) for a, s in zip(flat, sh_flat)])
        else:
            aux = jax.tree.map(
                lambda a: a if isinstance(a, jax.Array) else jax.device_put(a),
                loss_fn.aux)
        return loss_fn.fn, aux
    return (lambda params, _aux: loss_fn(params)), None
