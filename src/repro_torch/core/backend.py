"""Engine backends of the port's middleware copy.

The reference's engines (``BatchDispatchEngine``, ``BatchClientEngine``,
``HostArrays``) take ``backend="numpy"`` or ``"jax"``; the port keeps the
NumPy passes only. A ``"torch"`` engine backend is ROADMAP item A11.
"""
from __future__ import annotations

BACKENDS = ("numpy",)


def resolve_backend(backend: str) -> str:
    """Validate a ``backend=`` engine argument: only ``"numpy"`` is ported."""
    if backend not in BACKENDS:
        raise ValueError(
            f"unknown backend {backend!r}; the port's engines run {BACKENDS} only "
            "(a 'torch' engine backend is ROADMAP A11)"
        )
    return backend
