"""Global numeric configuration.

The reference implementation forces float64 everywhere
(``tf.keras.backend.set_floatx('float64')``, reference covmat.py:2,
lcgp.py:16).  The JAX analogue is the x64 flag; we enable it at import
unless the user opts out with ``LCGP_TPU_NO_X64=1``.

Precision modes
---------------
``'high'``  : float64 end-to-end (parity with the reference).
``'mixed'`` : f64 data/Gram/reductions with mixed-precision factorizations
              (f32 Cholesky + f64-GEMM Newton refinement, ops/mixed.py).
              Contract: the loss agrees with 'high' to ~1e-8 relative in
              the moderate-conditioning regime (benchmarks/validate_mixed.py).
``'fast'``  : float32 Gram construction + factorizations with a jitter
              floor.

Matmul precision
----------------
Unless told otherwise, an f32 matmul on an Ampere/Hopper GPU may run in
TF32 (10-bit mantissa, ~3 decimal digits).  That silently downgrades every
raw f32 GEMM of the 'fast' and 'mixed' paths (chol_inverse's syrk, predict
recombinations, blocked trailing updates — a TF32-grade Schur update can
break the PSD margin of a factorization target and NaN the factor), so the
import pins ``jax_default_matmul_precision='float32'``: true f32 GEMMs.
``LCGP_TPU_FAST_MATMUL=1`` skips the pin, which allows TF32 — only for
users who accept ~1e-3 relative error in f32 products.  f64 products are
unaffected either way.

Compile cache
-------------
If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX uses it and nothing here
overrides it.  Otherwise compiled executables persist in ``.jax_cache/``
at the checkout root — a fixed path, since the path is part of what makes
a later process find the entry.
"""
from __future__ import annotations

import os

import jax
import jax.numpy as jnp

if not os.environ.get("LCGP_TPU_NO_X64"):
    jax.config.update("jax_enable_x64", True)

# True f32 GEMMs unless the user allows TF32 (module docstring).
if not os.environ.get("LCGP_TPU_FAST_MATMUL"):
    jax.config.update("jax_default_matmul_precision", "float32")

COMPILE_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def configure_compile_cache():
    """Point JAX's persistent compile cache at ``COMPILE_CACHE_DIR`` unless
    ``JAX_COMPILATION_CACHE_DIR`` already names one.  Returns the directory
    this call set, or None when the environment's choice stands."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    jax.config.update("jax_compilation_cache_dir", COMPILE_CACHE_DIR)
    return COMPILE_CACHE_DIR


configure_compile_cache()


_PRECISION_DTYPES = {
    "high": jnp.float64,
    # sentinel string threaded through the static compute_dtype arg; the
    # Gram builds treat it as f64, the factorizations switch to ops/mixed
    "mixed": "mixed",
    "fast": jnp.float32,
}

# Jitter added to the diagonal of Cholesky targets in 'fast' (f32) mode to
# keep factorizations stable.  'high' mode adds nothing: the reference adds
# nothing, and parity demands the same conditioning behavior.
_PRECISION_JITTER = {
    "high": 0.0,
    "mixed": 0.0,   # semantics match 'high'; the f32 *seed* factor may use
                    # an internal jitter that refinement removes
    "fast": 1e-6,
}


def dtype_for(precision: str):
    try:
        return _PRECISION_DTYPES[precision]
    except KeyError:
        raise ValueError(
            f"precision must be one of {sorted(_PRECISION_DTYPES)}, got {precision!r}"
        ) from None


def jitter_for(precision: str) -> float:
    return _PRECISION_JITTER[precision]


def default_dtype():
    """float64 when x64 is on (the default), float32 otherwise."""
    return jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
