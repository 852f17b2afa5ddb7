"""Test environment: force the CPU backend with 8 virtual devices so the
multi-device sharding tests run without accelerators (set before jax is
imported)."""

import os

# Force-set (not setdefault): a JAX_PLATFORMS inherited from an outer
# shell must not move the suite onto an accelerator.
os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# x64 available for float64 oracle comparisons; solvers pass explicit f32
# dtypes so this does not change their precision.
import jax  # noqa: E402

from fluidsims_tpu.core.platform import enable_compile_cache  # noqa: E402

jax.config.update("jax_enable_x64", True)

# Persistent compile cache: eager scalar ops in the unit tests each trigger a
# small XLA compile; caching them across runs keeps the suite fast.
enable_compile_cache(jax)
