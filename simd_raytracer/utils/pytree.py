"""Frozen dataclasses registered as JAX pytrees.

Fields declared with `static_field()` are metadata: they are part of the
treedef (so jit specializes on them), never traced.  Every other field is
a pytree leaf.  `.replace(**changes)` returns a modified copy.
"""

from __future__ import annotations

import dataclasses

import jax


def static_field(**kwargs):
    return dataclasses.field(metadata={"static": True}, **kwargs)


def pytree_dataclass(cls):
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = dataclasses.fields(cls)
    jax.tree_util.register_dataclass(
        cls,
        data_fields=[f.name for f in fields if not f.metadata.get("static")],
        meta_fields=[f.name for f in fields if f.metadata.get("static")])
    cls.replace = dataclasses.replace
    return cls
