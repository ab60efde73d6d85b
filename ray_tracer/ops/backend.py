"""The one place that picks the intersection path from the platform.

``backend="auto"`` resolves to the Pallas kernel (ops/pallas_intersect.py)
on a GPU and to the jnp oracle (ops/intersect.py) everywhere else. The
kernel compiles only for a GPU; elsewhere it runs in the Pallas
interpreter, and only when the caller asks for that (tests, dry runs).
"""

from __future__ import annotations

import jax

BACKENDS = ("auto", "jnp", "pallas")


def on_gpu() -> bool:
    return jax.default_backend() == "gpu"


def resolve_backend(backend: str) -> str:
    """"auto" → "pallas" on a GPU, "jnp" elsewhere; explicit names pass."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}")
    if backend == "auto":
        return "pallas" if on_gpu() else "jnp"
    return backend


def kernel_interpret(interpret: bool) -> bool:
    """The kernel's ``interpret`` flag: as asked on a GPU; off a GPU the
    caller must ask for the interpreter, or this raises."""
    if not interpret and not on_gpu():
        raise RuntimeError(
            f"the Pallas intersection kernel compiles only for a GPU (this "
            f"process runs on {jax.default_backend()!r}); use backend='jnp', "
            f"or ask for the interpreter with interpret=True")
    return bool(interpret)
