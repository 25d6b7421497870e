"""The database resident in device memory, for the resident scorer (K3).

The codes are repacked so every sequence starts on a ``SLOT``-byte
boundary and uploaded once as one ``uint8`` tensor; grouped launches then
ship (G, B) int64 starts and int32 lengths instead of (G, B, N) target
slabs (``align/batch.py``, ``align/sw_grouped.py``).  The upload is kept
in a one-entry cache keyed by the database (``get_resident_db``), so a
second run on the same database in one process reuses it.

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
* no mesh: one card (replication across cards is ROADMAP item 11).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import native
from .batch import T_BUCKET
from .host import PackedTargets, _length_rung

SLOT = 16


class ResidentDB:
    """Slot-packed database codes on ``device`` (one upload)."""

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

    def __init__(self, host_codes: np.ndarray, offsets: np.ndarray, device):
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
        self.device = torch.device(device)
        self.pack_seconds = time.perf_counter() - t0
        t0 = time.perf_counter()
        # on the CPU the tensor shares the host buffer; on a card it is
        # the one upload of the run
        self.dev = torch.from_numpy(buf).to(self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.upload_seconds = time.perf_counter() - t0

    def packed_targets(self, ids: np.ndarray, lens: np.ndarray) -> PackedTargets:
        """(codes, starts, lens) over the SLOTTED host buffer for record
        ids — consumable by every backend; the resident launch path
        recognizes the identity of ``codes`` and ships starts only."""
        return PackedTargets(self.host_slotted, self.slot_off[ids], lens)


_RESIDENT_CACHE: dict = {}


def _resident_key(host_codes: np.ndarray, offsets: np.ndarray, device):
    # backing file + record span, as in the JAX package; the device takes
    # the place of its mesh (an upload to one device is not another's)
    return (getattr(host_codes, "filename", None)
            or getattr(getattr(host_codes, "base", None), "filename", None)
            or id(host_codes),
            int(host_codes.shape[0]),
            int(offsets.shape[0]),
            int(offsets[0]) if offsets.shape[0] else 0,
            int(offsets[-1]) if offsets.shape[0] else 0,
            str(torch.device(device)))


def resident_db_cached(host_codes: np.ndarray, offsets: np.ndarray, device) -> bool:
    """True when the live ResidentDB already holds this database (its
    upload cost is sunk)."""
    return _RESIDENT_CACHE.get("key") == _resident_key(host_codes, offsets, device)


def drop_resident_db() -> bool:
    """Release the live resident database (its device memory returns to
    PyTorch's caching allocator).  Returns True when something was
    dropped."""
    had = "db" in _RESIDENT_CACHE
    _RESIDENT_CACHE.clear()
    return had


def get_resident_db(host_codes: np.ndarray, offsets: np.ndarray, device) -> ResidentDB:
    """One live ResidentDB at a time, keyed by (backing file, record span,
    device), so runs on the same database reuse the upload."""
    key = _resident_key(host_codes, offsets, device)
    if _RESIDENT_CACHE.get("key") != key:
        _RESIDENT_CACHE.clear()
        db = ResidentDB(host_codes, offsets, device)  # key set only on
        # success: a failed build must not poison the cache
        _RESIDENT_CACHE["key"] = key
        _RESIDENT_CACHE["db"] = db
    return _RESIDENT_CACHE["db"]
