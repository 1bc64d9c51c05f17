"""Build the port's configuration objects from the JAX package's.

This system has no weights: what parameterises an encode is `Options`,
`BC7EncodingPlan` and the tables. These helpers read the attributes of the
reference package's dataclass instances by duck typing (without importing
that package) and build the port's instances, so both packages can encode
with the same configuration.
"""

from __future__ import annotations

import dataclasses

from .bc7_plan import BC7EncodingPlan
from .options import Options


def _fields_from(cls, obj):
    kwargs = {}
    for f in dataclasses.fields(cls):
        if not hasattr(obj, f.name):
            raise TypeError(f"{type(obj).__name__} has no field {f.name!r}")
        kwargs[f.name] = getattr(obj, f.name)
    return kwargs


def options_from_reference(obj) -> Options:
    """Options with every field copied from `obj`."""
    return Options(**_fields_from(Options, obj))


def plan_from_reference(obj) -> BC7EncodingPlan:
    """BC7EncodingPlan with every field copied from `obj` (tuples kept as
    plain Python ints so the plan stays hashable)."""
    kwargs = _fields_from(BC7EncodingPlan, obj)
    for name, value in kwargs.items():
        if isinstance(value, tuple):
            kwargs[name] = tuple(tuple(int(x) for x in v)
                                 if isinstance(v, tuple) else int(v)
                                 for v in value)
        elif isinstance(value, bool):
            kwargs[name] = bool(value)
        else:
            kwargs[name] = int(value)
    return BC7EncodingPlan(**kwargs)
