"""Configuration base machinery shared by every solver.

The reference repo gives each program its own `struct Params`/`SimConfig`
populated by getopt and uploaded to CUDA constant memory (e.g.
tau_hypersonic_cuda.cu:37-50, tau_gray_scott.cu:43-61).  Here every solver
gets a frozen dataclass; configs are *static* w.r.t. jit (hashable, passed as
Python objects so XLA specializes on them, the analog of `__constant__`
memory), with two-stage validation (parse-time type checks + physics checks)
mirroring tau_hypersonic_cuda.cu:1482-1639.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import jax.numpy as jnp

__all__ = ["BaseConfig", "ConfigError", "static_field"]


class ConfigError(ValueError):
    """Raised when a config fails physics/consistency validation."""


def static_field(**kwargs):
    return dataclasses.field(**kwargs)


@dataclass(frozen=True)
class BaseConfig:
    """Frozen, hashable config. Subclasses add fields + `validate()`."""

    def validate(self) -> None:  # pragma: no cover - overridden
        pass

    def __post_init__(self):
        self.validate()

    def replace(self, **kwargs):
        new = dataclasses.replace(self, **kwargs)
        return new

    def asdict(self) -> dict:
        return dataclasses.asdict(self)

    @property
    def jax_dtype(self):
        dt = getattr(self, "dtype", "float32")
        return jnp.dtype(dt)

    def _require(self, cond: bool, msg: str) -> None:
        if not cond:
            raise ConfigError(f"{type(self).__name__}: {msg}")
