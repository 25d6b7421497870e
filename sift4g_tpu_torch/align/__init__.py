"""Alignment scoring for the PyTorch port.

Backends of the port's BatchAligner:

* ``cuda``: the grouped scorer as a hand-written CUDA kernel, on the
  listed CUDA cards or every visible one (``parallel/sharded.py``);
* ``torch``: the same grouped launch policy through the plain PyTorch
  twin on the CPU (tests and hosts without a GPU);
* ``native``: the threaded C++ DP of the port's native host library.

``auto`` means ``cuda``.  A host without a GPU gets an error, never a
silent run on the CPU: ask for ``torch`` or ``native`` by name there.
"""

from __future__ import annotations

import torch

BACKENDS = ("auto", "cuda", "torch", "native")


def best_backend() -> str:
    """The backend ``auto`` stands for: ``cuda``, when torch sees a GPU."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible: --backend cuda (the default) needs a "
            "GPU; on a host without one ask for --backend torch or native"
        )
    return "cuda"


def resolve_backend(backend: str, cards=None):
    """(backend, devices) for a backend name and the reference's card list.

    ``cuda`` (and ``auto``) run on exactly the listed local cards, in
    order, or on every visible card when ``cards`` is empty or None (the
    JAX package's default of every local device); an index past the
    visible cards raises ValueError.  ``torch`` and ``native`` run on the
    CPU and ignore ``cards``, as the JAX package's native path does."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; choose from {BACKENDS}")
    if backend not in ("auto", "cuda"):
        return backend, [torch.device("cpu")]
    backend = best_backend()
    from ..parallel.sharded import make_mesh

    return backend, make_mesh(cards=cards)
