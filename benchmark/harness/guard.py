"""The run's guard against the JAX package: no module whose top-level
name (the part before the first dot, compared whole) is one of these."""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "radio_mapper_tpu")


def forbidden_modules(modules=None) -> list:
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))
