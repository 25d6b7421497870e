"""The database resident in device memory, for the resident scorer (K3).

The codes are repacked so every sequence starts on a ``SLOT``-byte
boundary and uploaded as one ``uint8`` tensor to every device the aligner
runs on (once per distinct device: the JAX package replicates it across
its mesh, and the reference gives every card the whole filtered database,
database_alignment.cpp:80-81); grouped launches then ship (G, B) int64
starts and int32 lengths instead of (G, B, N) target slabs
(``align/batch.py``, ``align/sw_grouped.py``).  The uploads are kept in a
one-entry cache keyed by the database and the devices
(``get_resident_db``), so a second run on the same database in one
process reuses them.

``host_slotted`` stays in host memory: :meth:`ResidentDB.packed_targets`
builds ``PackedTargets`` over it, which the traceback and every other
host consumer read like any packed candidates, and the aligner recognises
by the identity of their ``codes`` buffer.

Re-derived for Hopper from ``sift4g_tpu/align/batch.py:73-271``:

* the slot is 16 bytes, not 1024: the 1024-byte slot was the Mosaic DMA
  grain for 1-D u8 HBM slices on the TPU; the CUDA kernel needs only that
  its 16-byte ``uint4`` loads start aligned, and a 16-byte slot costs
  about 8 bytes of padding per sequence instead of about 670;
* one tensor, no segments: the < 2 GiB segments, ``SEG_CAP`` and the
  128 MiB ``DEV_GRAIN`` served int32 byte offsets in the TPU runtime and
  a bounded set of jit shapes; the starts here are int64 and PyTorch has
  no compiled shapes;
* the tail pad is the largest rung any sequence of the database buckets
  into, so a row's ``n_pad``-byte window (the plain version gathers it
  whole) stays inside the tensor past the last sequence;
* the mesh is the aligner's device list: one copy per distinct device,
  and the cache key holds the devices where the JAX key holds the mesh.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import native
from .batch import T_BUCKET
from .host import PackedTargets, _length_rung

SLOT = 16


def free_device_bytes(device: torch.device) -> int:
    """Free memory on a card: the free bytes ``cudaMemGetInfo`` reports
    plus the blocks PyTorch's caching allocator holds but does not use."""
    free, _total = torch.cuda.mem_get_info(device)
    cached = torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)
    return int(free) + int(cached)


def distinct_devices(devices) -> list:
    """A device or a list of devices as a list of distinct torch.devices,
    in order of first appearance."""
    if isinstance(devices, (list, tuple)):
        return list(dict.fromkeys(torch.device(d) for d in devices))
    return [torch.device(devices)]


class ResidentDB:
    """Slot-packed database codes on ``devices`` (one upload to each
    distinct device; a single device may be given as it is)."""

    @staticmethod
    def slotted_size(offsets: np.ndarray) -> int:
        lens = np.diff(offsets)
        slots = np.maximum((lens + SLOT - 1) // SLOT, 1)
        return int(slots.sum()) * SLOT

    @staticmethod
    def tail_pad(offsets: np.ndarray) -> int:
        """Bytes after the last slot: the largest rung of the database."""
        max_len = int(np.diff(offsets).max()) if offsets.shape[0] > 1 else 0
        return _length_rung(max_len, T_BUCKET)

    def __init__(self, host_codes: np.ndarray, offsets: np.ndarray, devices):
        t0 = time.perf_counter()
        n_seq = offsets.shape[0] - 1
        lens = np.diff(offsets).astype(np.int64)
        slot_bytes = np.maximum(-(-lens // SLOT), 1) * SLOT
        total = int(slot_bytes.sum())
        buf = np.zeros(total + self.tail_pad(offsets), dtype=np.uint8)
        lib = native.load()
        if lib is not None and n_seq:
            import ctypes

            u8p = ctypes.POINTER(ctypes.c_uint8)
            i64p = ctypes.POINTER(ctypes.c_int64)
            codes = host_codes if host_codes.flags["C_CONTIGUOUS"] else np.ascontiguousarray(host_codes)
            # astype always copies: the -= below must never write through
            # to the caller's offsets array
            offs = offsets.astype(np.int64)
            offs -= offs[0]
            slot_off = np.empty(n_seq, dtype=np.int64)
            lib.sift4g_slot_pack(
                ctypes.cast(codes.ctypes.data + int(offsets[0]), u8p),
                offs.ctypes.data_as(i64p), n_seq,
                buf.ctypes.data_as(u8p), slot_off.ctypes.data_as(i64p), SLOT,
            )
        else:
            slot_off = np.concatenate(([0], np.cumsum(slot_bytes)[:-1])).astype(np.int64)
            for i in range(n_seq):
                pos = int(slot_off[i])
                buf[pos : pos + int(lens[i])] = host_codes[offsets[i] : offsets[i + 1]]
        self.host_slotted = buf
        self.slot_off = slot_off      # int64 byte start of each sequence
        self.nbytes = total
        self.devices = distinct_devices(devices)
        self.pack_seconds = time.perf_counter() - t0
        t0 = time.perf_counter()
        # on the CPU the tensor shares the host buffer; on a card it is
        # the run's one upload to that card
        host = torch.from_numpy(buf)
        self.copies = {d: host.to(d, non_blocking=True) for d in self.devices}
        for d in self.devices:
            if d.type == "cuda":
                torch.cuda.synchronize(d)
        self.upload_seconds = time.perf_counter() - t0
        self.dev = self.copies[self.devices[0]]

    def on(self, device) -> torch.Tensor:
        """The resident tensor on ``device``."""
        try:
            return self.copies[torch.device(device)]
        except KeyError:
            raise ValueError(f"the resident database is not on {device}") from None

    def packed_targets(self, ids: np.ndarray, lens: np.ndarray) -> PackedTargets:
        """(codes, starts, lens) over the SLOTTED host buffer for record
        ids — consumable by every backend; the resident launch path
        recognizes the identity of ``codes`` and ships starts only."""
        return PackedTargets(self.host_slotted, self.slot_off[ids], lens)


_RESIDENT_CACHE: dict = {}


def _resident_key(host_codes: np.ndarray, offsets: np.ndarray, devices):
    # backing file + record span, as in the JAX package; the devices take
    # the place of its mesh (an upload to one device is not another's)
    return (getattr(host_codes, "filename", None)
            or getattr(getattr(host_codes, "base", None), "filename", None)
            or id(host_codes),
            int(host_codes.shape[0]),
            int(offsets.shape[0]),
            int(offsets[0]) if offsets.shape[0] else 0,
            int(offsets[-1]) if offsets.shape[0] else 0,
            tuple(str(d) for d in distinct_devices(devices)))


def resident_db_cached(host_codes: np.ndarray, offsets: np.ndarray, devices) -> bool:
    """True when the live ResidentDB already holds this database on these
    devices (its upload cost is sunk)."""
    return _RESIDENT_CACHE.get("key") == _resident_key(host_codes, offsets, devices)


def drop_resident_db() -> bool:
    """Release the live resident database (its device memory returns to
    PyTorch's caching allocator).  Returns True when something was
    dropped."""
    had = "db" in _RESIDENT_CACHE
    _RESIDENT_CACHE.clear()
    return had


def get_resident_db(host_codes: np.ndarray, offsets: np.ndarray, devices) -> ResidentDB:
    """One live ResidentDB at a time, keyed by (backing file, record span,
    devices), so runs on the same database reuse the uploads."""
    key = _resident_key(host_codes, offsets, devices)
    if _RESIDENT_CACHE.get("key") != key:
        _RESIDENT_CACHE.clear()
        db = ResidentDB(host_codes, offsets, devices)  # key set only on
        # success: a failed build must not poison the cache
        _RESIDENT_CACHE["key"] = key
        _RESIDENT_CACHE["db"] = db
    return _RESIDENT_CACHE["db"]
