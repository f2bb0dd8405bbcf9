"""Test harness config: run on a virtual 8-device CPU mesh.

Must execute before jax initializes a backend: the platform is forced
through jax.config, so the suite stays on the CPU even where an
accelerator is present and JAX_PLATFORMS is unset."""
import os

flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import sys  # noqa: E402

# `import oracle` (the NumPy parity oracle) must resolve both when the
# suite runs from the source tree (rootdir import) and when installed as
# the lcgp_tpu.tests package (pytest --pyargs lcgp_tpu.tests).
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
