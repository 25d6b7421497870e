"""Alignment scoring for the PyTorch port.

Backends of the port's BatchAligner:

* ``cuda``: the grouped scorer as a hand-written CUDA kernel on one GPU;
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


def resolve_backend(backend: str, card: int = 0):
    """(backend, torch.device) for a backend name and a local GPU index."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; choose from {BACKENDS}")
    if backend in ("auto", "cuda"):
        backend = best_backend()
    else:
        return backend, torch.device("cpu")
    n = torch.cuda.device_count()
    if not 0 <= card < n:
        raise ValueError(f"card {card} out of range: {n} CUDA device(s) visible")
    return backend, torch.device("cuda", card)
