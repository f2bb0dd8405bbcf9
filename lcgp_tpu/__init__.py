"""lcgp_tpu — Latent Component Gaussian Process emulator in JAX.

Public API mirrors the reference package (reference src/lcgp/__init__.py):
``LCGP``, ``Matern32``, ``test``, plus the evaluation module and extras
(datasets, runner, parallel helpers).
"""
from . import config as _config  # noqa: F401  (enables x64 before anything else)

from .models.lcgp import LCGP
from .ops.matern import Matern32
from . import evaluation
from . import datasets
from .test import test

# Resolve the version from installed package metadata when available
# (reference src/lcgp/__init__.py:5-11); fall back to the source tree's
# pyproject value when running uninstalled.
try:
    from importlib.metadata import PackageNotFoundError, version
    __version__ = version('lcgp_tpu')
except PackageNotFoundError:
    __version__ = '0.1.0'
__all__ = ['LCGP', 'Matern32', 'test', 'evaluation', 'datasets', '__version__']
