"""The import guard: what the benchmark may not load.

A module counts by its top-level name, the part before the first dot,
compared whole: ``horovod_tpu_torch`` is the program and allowed,
``horovod_tpu`` is the JAX package and refused.
"""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "horovod_tpu"})
PROGRAM = "horovod_tpu_torch"


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def forbidden_loaded(modules=None) -> list:
    """The loaded modules whose top-level name is forbidden, sorted."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if top_level(n) in FORBIDDEN)


def check(where: str) -> None:
    """Exit with code 3, naming what was found on standard error, if a
    forbidden module is loaded."""
    found = forbidden_loaded()
    if found:
        print(f"perfbench: {where}: forbidden modules loaded: "
              f"{', '.join(found)}", file=sys.stderr, flush=True)
        raise SystemExit(3)
