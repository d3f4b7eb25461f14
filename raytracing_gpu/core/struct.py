"""Frozen dataclasses that are JAX pytrees.

`dataclass` registers a frozen dataclass with `jax.tree_util`: fields made
with `static_field` are static metadata (they select the compiled program and
are never traced), every other field is a pytree child.  `replace` returns a
copy with some fields changed.
"""

from __future__ import annotations

import dataclasses

import jax


def static_field(default=dataclasses.MISSING):
    """A field kept as pytree metadata rather than as a traced child."""
    return dataclasses.field(default=default, metadata={"static": True})


def dataclass(cls):
    cls = dataclasses.dataclass(frozen=True)(cls)
    cls.replace = lambda self, **changes: dataclasses.replace(self, **changes)
    return jax.tree_util.register_dataclass(cls)
