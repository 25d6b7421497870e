"""Host-facing batched scoring for the port: bucketing, packing, launches.

The host policy is the JAX package's (``sift4g_tpu/align/batch.py``):
targets are bucketed on the padded-length rung ladder, each
(query, rung) bucket is cut into groups of the rung's batch width, the
sub-width remainders take ``pow2`` widths and coalesce upward across
rungs, target slabs are filled by the native ``sift4g_pack_group``, and
``scores_many_async`` dispatches everything at once and fetches the
results in ONE device-to-host copy when its closure runs.

With a resident database (``align/resident.py``) a launch whose every
group holds ``PackedTargets`` over ``resident.host_slotted`` ships only
(G, B) int64 starts and int32 lengths and runs the resident kernel K3;
any other launch packs a slab for K1.  Buckets need no segment key: the
resident tensor is one, and the groups' rows stay ascending in database
id as the screen's tie order needs.

What differs is what the TPU constrained.  A launch costs microseconds
here, not the tens of milliseconds of the TPU runtime, and the kernel
keeps its DP state in device memory rather than VMEM, so:

* every rung goes through the one grouped kernel: the kernel's scratch
  grows with the rung, never with the query, so there is no long-target
  route and no query-length fallback;
* the batch width is the screen's 4096-row limit, cut only where one
  group's scratch would pass the launch budget;
* a launch holds as many groups of a bucket as the scratch budget allows
  (``G * B`` threads, up to a million: enough to fill 132 SMs), with no
  padding to fixed grid sizes.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..native import load as load_native
from . import resolve_backend
from .host import (
    PAD_CODE,
    PackedTargets,
    _length_rung,
    _length_rungs_vec,
    score_pairs_batch,
)
from .scan import (
    SCREEN_MAX_SCORE,
    SCREEN_ROW_MASK,
    decode_screen_words,
    matrix32_from_scorer,
    screen_topk_words,
)
from .sw_grouped import sw_scores_grouped, sw_scores_grouped_resident

# the screen packs the row index into 12 bits (align/scan.py)
MAX_BATCH = SCREEN_ROW_MASK + 1
# kernel scratch per launch, 8 bytes per (group, target, column): 2 GiB
# on a GPU leaves nearly all of an 80 GB card free and still admits a
# million threads at the common rungs; the CPU twin's temporaries are
# about ten times its scratch, hence the smaller CPU budget
SCRATCH_BYTES = {"cuda": 2 << 30, "cpu": 128 << 20}
MAX_GROUPS = 65535    # CUDA grid y-dimension limit
T_BUCKET = 128        # base of the padded-length rung ladder


class BatchAligner:
    """Scores queries against many targets; backend 'cuda' | 'torch' | 'native'
    ('auto' = 'cuda')."""

    def __init__(
        self,
        scorer,
        mode: str = "SW",
        backend: str = "auto",
        device=None,
        b_cap: int = 0,
        tail_policy: str = "pow2",
        tail_coalesce: bool = True,
        threads: int = 0,
        resident=None,
    ):
        if device is None:
            backend, device = resolve_backend(backend)
        elif backend == "auto":
            backend = "cuda"
        device = torch.device(device)
        if backend == "cuda" and device.type != "cuda":
            raise ValueError(f"backend cuda needs a CUDA device, got {device}")
        if backend == "torch" and device.type != "cpu":
            raise ValueError(f"backend torch runs the twin on the CPU, got {device}")
        if tail_policy not in ("full", "pow2"):
            raise ValueError(f"tail_policy must be 'full' or 'pow2', got {tail_policy!r}")
        self.scorer = scorer
        self.mode = mode
        self.backend = backend
        self.device = device
        # optional batch-width cap: tests use it to force many groups
        self.b_cap = b_cap
        # "pow2" shrinks the one remainder group per (query, rung) to the
        # smallest 256 * 2^k that holds it; "full" pads it to the rung's
        # batch width.  Scores are identical either way.
        self.tail_policy = tail_policy
        # merge a query's remainders from smaller rungs into a larger
        # rung's when that costs fewer padded cells (exact: a target is
        # scored exactly at any rung >= its length)
        self.tail_coalesce = tail_coalesce
        self.threads = threads
        self.scratch_bytes = SCRATCH_BYTES[device.type]
        self.launches = 0
        # device-resident database (align/resident.ResidentDB) or None
        self.resident = resident
        self._matrix32 = None

    def _b_for(self, n_pad: int) -> int:
        """Batch width of a full group at rung ``n_pad``."""
        b = self.scratch_bytes // (8 * n_pad) // 32 * 32
        b = max(32, min(MAX_BATCH, b))
        return min(b, self.b_cap) if self.b_cap else b

    def _group_width(self, count: int, bcap: int) -> int:
        """Batch width for one group of ``count`` targets (tail policy)."""
        if self.tail_policy != "pow2" or count >= bcap:
            return bcap
        bw = 256
        while bw < count:
            bw *= 2
        return min(bw, bcap)

    def _coalesce_tails(self, tails):
        """Merge one query's per-rung remainder groups upward.

        ``tails``: list of (n_pad, idx_array).  Greedy largest-rung-first:
        a smaller rung's remainder joins the pool at rung R when the
        merged group costs fewer padded cells than the two separate
        groups and fits rung R's batch width."""
        if not self.tail_coalesce or len(tails) <= 1:
            return tails
        tails = sorted(tails, key=lambda t: -t[0])
        out = []
        R, pool = tails[0]
        for r, idxs in tails[1:]:
            cap = self._b_for(R)
            merged = len(pool) + len(idxs)
            cost_merged = self._group_width(merged, cap) * R
            cost_split = (
                self._group_width(len(pool), cap) * R
                + self._group_width(len(idxs), self._b_for(r)) * r
            )
            if merged <= cap and cost_merged <= cost_split:
                pool = np.concatenate([pool, idxs])
            else:
                out.append((R, pool))
                R, pool = r, idxs
        out.append((R, pool))
        return out

    def scores_many(self, items) -> List[np.ndarray]:
        return self.scores_many_async(items)()

    def scores_many_async(self, items, screen=None):
        """Dispatch scoring for many (query_codes, targets) pairs; returns a
        zero-arg fetch closure producing List[np.ndarray] (int64).

        ``screen=(smins, k)`` opts into the exact device-side E-value
        screen: launches return each group's ``k`` best survivor words
        (``score >= smins[i]``) instead of its scores, and every other
        slot of the dense result stays 0, which is exact for callers that
        keep ``score >= smins[i]``."""
        if self.backend == "native":
            res = [
                score_pairs_batch(q, t, self.scorer, self.mode, threads=self.threads)
                for q, t in items
            ]
            return lambda: res
        return self._scores_grouped(items, screen)

    def _buckets(self, items):
        """(n_pad, B) -> [(item_idx, ascending target-index array)]."""
        buckets = {}
        for item_idx, (_, targets) in enumerate(items):
            if len(targets) == 0:
                continue
            if isinstance(targets, PackedTargets):
                rungs = _length_rungs_vec(targets.lens, T_BUCKET)
                order = np.argsort(rungs, kind="stable")
                uniq, first = np.unique(rungs[order], return_index=True)
                bounds = list(first[1:]) + [len(order)]
                per_np = {
                    int(u): order[lo:hi] for u, lo, hi in zip(uniq, first, bounds)
                }
            else:
                per_np = {}
                for i, t in enumerate(targets):
                    per_np.setdefault(_length_rung(t.shape[0], T_BUCKET), []).append(i)
            tails = []
            for n_pad, idxs in per_np.items():
                idxs = np.asarray(idxs, dtype=np.int64)
                bcap = self._b_for(n_pad)
                n_full = len(idxs) // bcap * bcap
                for pos in range(0, n_full, bcap):
                    buckets.setdefault((n_pad, bcap), []).append(
                        (item_idx, idxs[pos : pos + bcap])
                    )
                if n_full < len(idxs):
                    tails.append((n_pad, idxs[n_full:]))
            for n_pad, chunk_idx in self._coalesce_tails(tails):
                bw = self._group_width(len(chunk_idx), self._b_for(n_pad))
                # ascending target order keeps rows ascending in database
                # id, which the screen's tie order relies on
                buckets.setdefault((n_pad, bw), []).append(
                    (item_idx, np.sort(chunk_idx))
                )
        return buckets

    def _scores_grouped(self, items, screen):
        out = [np.zeros(len(t), dtype=np.int64) for _, t in items]
        q_lens = [int(q.shape[0]) for q, _ in items]
        if self._matrix32 is None:
            self._matrix32 = matrix32_from_scorer(self.scorer, self.device)

        # screen gate: every item needs an integer threshold >= 1 (so
        # padding rows never survive) and the largest possible score must
        # fit the word's 19-bit score field
        scr_k, smins = 0, None
        if screen is not None:
            smins, scr_k = screen
            max_sub = int(self.scorer.matrix.max())
            if (
                scr_k < 1
                or len(smins) != len(items)
                or any(s is None or s < 1 for s in smins)
                or (q_lens and max(q_lens) * max_sub > SCREEN_MAX_SCORE)
            ):
                scr_k, smins = 0, None

        native_lib = load_native()
        devs = []
        for (n_pad, B), groups in sorted(self._buckets(items).items()):
            g_cap = max(1, min(MAX_GROUPS, self.scratch_bytes // (8 * B * n_pad)))
            for gpos in range(0, len(groups), g_cap):
                part = groups[gpos : gpos + g_cap]
                devs.append(self._launch(items, part, n_pad, B, scr_k, smins, native_lib))

        def fetch() -> List[np.ndarray]:
            if not devs:
                return out
            flat = torch.cat([d[0].reshape(-1) for d in devs]).cpu().numpy()
            pos = 0
            for res, b, groups, k_eff, _host in devs:
                w = k_eff if k_eff else b
                for gi, (item_idx, chunk_idx) in enumerate(groups):
                    seg = flat[pos + gi * w : pos + (gi + 1) * w]
                    if k_eff:
                        rows, sc = decode_screen_words(seg, b)
                        out[item_idx][chunk_idx[rows]] = sc
                    else:
                        out[item_idx][chunk_idx] = seg[: len(chunk_idx)]
                pos += len(groups) * w
            devs.clear()   # the copies are done: release the host buffers
            return out

        return fetch

    def _part_resident(self, items, part) -> bool:
        """True when every group of the launch reads the resident db."""
        if self.resident is None:
            return False
        return all(
            isinstance(items[ii][1], PackedTargets)
            and items[ii][1].codes is self.resident.host_slotted
            for ii, _ in part
        )

    def _launch(self, items, part, n_pad, B, scr_k, smins, native_lib):
        """Pack one launch's groups into host buffers, queue the copies,
        the kernel and the screen; returns (result, B, part, k, host
        buffers).  The host buffers must live until the fetch: the copies
        from them are asynchronous."""
        G = len(part)
        resident = self._part_resident(items, part)
        pin = self.device.type == "cuda"
        # distinct queries of this launch, concatenated
        local_off, local_parts, n_q = {}, [], 0
        for item_idx, _ in part:
            if item_idx not in local_off:
                local_off[item_idx] = n_q
                local_parts.append(items[item_idx][0])
                n_q += items[item_idx][0].shape[0]
        # one int32 host buffer for the small arrays:
        # [lens (G*B) | q_off (G) | q_len (G) | smin (G) | queries]
        meta_t = torch.empty(G * B + 3 * G + max(n_q, 1), dtype=torch.int32, pin_memory=pin)
        meta = meta_t.numpy()
        tl = meta[: G * B].reshape(G, B)
        qoff = meta[G * B : G * B + G]
        qlen = meta[G * B + G : G * B + 2 * G]
        smin = meta[G * B + 2 * G : G * B + 3 * G]
        q_local = meta[G * B + 3 * G :]
        tl[:] = 0
        q_local[:] = PAD_CODE
        if local_parts:
            q_local[:n_q] = np.concatenate(local_parts)
        if resident:
            # (G, B) int64 starts into the resident tensor; padding rows
            # keep start 0 and length 0
            tg_t = torch.zeros((G, B), dtype=torch.int64, pin_memory=pin)
        else:
            tg_t = torch.empty((G, B, n_pad), dtype=torch.int8, pin_memory=pin)
        tg = tg_t.numpy()
        if native_lib is None and not resident:
            tg.fill(PAD_CODE)
        for gi, (item_idx, chunk_idx) in enumerate(part):
            targets = items[item_idx][1]
            qoff[gi] = local_off[item_idx]
            qlen[gi] = items[item_idx][0].shape[0]
            if smins is not None:
                smin[gi] = smins[item_idx]
            if resident:
                tg[gi, : len(chunk_idx)] = targets.starts[chunk_idx]
                tl[gi, : len(chunk_idx)] = targets.lens[chunk_idx]
            elif native_lib is not None:
                # bytes past each length stay uninitialized: the kernel
                # never reads them and the twin masks them (& 31)
                _pack_native(native_lib, targets, chunk_idx, n_pad, tg[gi], tl[gi])
            else:
                for r, i in enumerate(chunk_idx):
                    t = targets[i]
                    tg[gi, r, : t.shape[0]] = t
                    tl[gi, r] = t.shape[0]

        dev = self.device
        meta_d = meta_t.to(dev, non_blocking=True)
        tg_d = tg_t.to(dev, non_blocking=True)
        o = G * B
        query_args = (meta_d[o + 3 * G :], meta_d[o : o + G], meta_d[o + G : o + 2 * G])
        gaps = dict(mode=self.mode, gap_open=self.scorer.gap_open,
                    gap_extend=self.scorer.gap_extend)
        if resident:
            scores = sw_scores_grouped_resident(
                *query_args, self.resident.dev, tg_d, meta_d[:o].view(G, B),
                self._matrix32, n_pad, **gaps,
            )
        else:
            scores = sw_scores_grouped(
                *query_args, tg_d, meta_d[:o].view(G, B), self._matrix32, **gaps,
            )
        self.launches += 1
        k_eff = min(B, scr_k) if smins is not None else 0
        if k_eff:
            scores = screen_topk_words(scores, meta_d[o + 2 * G : o + 3 * G], k_eff)
        return scores, B, part, k_eff, (meta_t, tg_t)


def _pack_native(lib, targets, chunk_idx, n_pad, tg_rows, tl_row) -> None:
    """Fill one group's (B, n_pad) slab rows and lengths with the native
    memcpy packer (``native/pack.cpp``)."""
    import ctypes

    if isinstance(targets, PackedTargets):
        ptrs = (targets.codes.ctypes.data + targets.starts[chunk_idx]).astype(np.uint64)
        lens_in = np.ascontiguousarray(targets.lens[chunk_idx])
    else:
        sel = [targets[i] for i in chunk_idx]
        ptrs = np.fromiter((t.ctypes.data for t in sel), dtype=np.uint64, count=len(sel))
        lens_in = np.fromiter((t.shape[0] for t in sel), dtype=np.int32, count=len(sel))
    lib.sift4g_pack_group(
        ptrs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        lens_in.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        int(lens_in.shape[0]),
        n_pad,
        tg_rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        tl_row.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
