"""Host-facing batched scoring for the port: bucketing, packing, launches.

The host policy is the JAX package's (``sift4g_tpu/align/batch.py``):
targets are bucketed on the padded-length rung ladder, each
(query, rung) bucket is cut into groups of the rung's batch width, the
sub-width remainders take ``pow2`` widths and coalesce upward across
rungs, target slabs are filled by the native ``sift4g_pack_group``, and
``scores_many_async`` dispatches everything at once and fetches the
results in ONE device-to-host copy when its closure runs.

A launch at a rung of ``LONG_RUNG`` or more runs the long-target kernel
K2 (``sw_scores_grouped_long``), as the JAX package sends every rung past
its planes budget (``sift4g_tpu/align/batch.py:854``) to its long-target
kernel, unless it holds so many cells that K1 would finish first
(``_long_route``); every other launch runs K1 (or K3, below).  Unlike
the JAX package, which launches its long rungs one query at a time, the
port keeps them grouped across queries, in ascending row order and
screened, like every other launch.

With a resident database (``align/resident.py``) a launch not sent to
K2 whose every group holds ``PackedTargets`` over
``resident.host_slotted`` ships only (G, B) int64 starts and int32
lengths and runs the resident kernel K3; any other launch packs a slab,
K2's too (the JAX package packs its resident long rungs from the host as
well).  Buckets need no segment key: the resident tensor is one,
and the groups' rows stay ascending in database id as the screen's tie
order needs.

Over several devices (a list, as ``parallel/sharded.py`` takes a mesh)
one logical launch is split across them: on the group axis
(``make_grouped_sharded``, ``make_grouped_resident_sharded``), or, when
the launch has fewer groups than devices, on the batch axis, every device
scoring all groups on its share of the rows
(``make_grouped_long_sharded``, the JAX package's long-target rule,
with K2 or K1 as above; such launches are not screened, since a group's
rows are spread over devices).  The host packs each device's share into
its own segment of the launch's one pinned buffer, each segment goes to
its device in one copy, and the fetch makes one device-to-host copy per
device.  ``launches`` counts a logical launch once, however many devices
it spans.

What differs is what the TPU constrained.  A launch costs microseconds
here, not the tens of milliseconds of the TPU runtime, and the kernel
keeps its DP state in device memory rather than VMEM, so:

* no kernel's memory grows with the query (K1's scratch grows with the
  rung, K2's with nothing but its strips), so there is no query-length
  fallback and no batch width shrunk for long queries;
* the batch width is the screen's 4096-row limit, cut only where one
  group's scratch would pass the launch budget;
* a launch holds as many groups of a bucket as the scratch budget allows
  (``G * B`` threads, up to a million: enough to fill 132 SMs), with no
  padding to fixed grid sizes.  The budget is per device, so a launch
  over n devices holds up to n times the groups, split unevenly where
  they do not divide.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..native import load as load_native
from ..parallel.sharded import (
    make_grouped_long_sharded,
    make_grouped_resident_sharded,
    make_grouped_sharded,
)
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
)

# the screen packs the row index into 12 bits (align/scan.py)
MAX_BATCH = SCREEN_ROW_MASK + 1
# kernel scratch per launch and device, 8 bytes per (group, target,
# column): 2 GiB on a GPU leaves nearly all of an 80 GB card free and
# still admits a million threads at the common rungs; the CPU twin's
# temporaries are about ten times its scratch, hence the smaller CPU
# budget
SCRATCH_BYTES = {"cuda": 2 << 30, "cpu": 128 << 20}
MAX_GROUPS = 65535    # CUDA grid y-dimension limit
T_BUCKET = 128        # base of the padded-length rung ladder
# the smallest rung scored by K2: the JAX package leaves its grouped
# kernel for the long-target one past 14 MiB of planes at B = 256
# (26 * n_pad * 256 bytes), from the 3072 rung on
LONG_RUNG = 3072
# which of K1 and K2 scores a launch at a long rung (``_long_route``): K1
# gives a target one warp, so a launch takes it about its longest target's
# columns for each pass over the query (K1_PASS_ROWS rows), however many
# targets it holds; K2 spreads a target over many warps and takes about
# the launch's cells at its full-card rate.  The constant is that rate
# times K1's time a column and pass, both from ``chip_smoke.py`` phase 3b
# on an H100: K2's 1.25-1.44 T cells/s on 1,024-4,096 full targets at 360
# query rows (its cluster kernel; 0.85-1.13 before) times K1's 0.250-0.260
# us a column at 64 targets gives 3.1e5-3.7e5 cells; at 1,500 rows,
# 1.45-1.57 T cells/s times 0.282-0.290 us, 4.1e5-4.6e5.  3 x 2^17 lies
# between: the crossover falls at 1,092 full targets at 360 rows, where
# K2 ran 1.00-1.07x K1 on 1,024, and at 786 at 1,500, where the two ran
# within 2 % of each other on 1,024
LONG_CELLS_PER_COLUMN = 3 << 17
K1_PASS_ROWS = 16 * 32    # TILE_ROWS x one warp a target


def _long_route(groups) -> bool:
    """True when K2 should score a launch at a long rung, given its
    groups as (query length, target lengths): its cells stay under
    ``LONG_CELLS_PER_COLUMN`` for each column and pass of K1's longest
    chain (its longest target times its passes over the query)."""
    cells = chain = 0
    for m, lens in groups:
        if len(lens):
            cells += m * int(np.sum(lens, dtype=np.int64))
            chain = max(chain, -(-m // K1_PASS_ROWS) * int(np.max(lens)))
    return cells < LONG_CELLS_PER_COLUMN * chain


def _target_lens(targets, idx) -> np.ndarray:
    if isinstance(targets, PackedTargets):
        return targets.lens[idx]
    return np.array([targets[i].shape[0] for i in idx], dtype=np.int64)


def _split(n: int, parts: int):
    """[lo, hi) bounds of ``n`` items cut into ``parts`` contiguous pieces
    whose sizes differ by at most one."""
    q, r = divmod(n, parts)
    bounds, lo = [], 0
    for p in range(parts):
        hi = lo + q + (p < r)
        bounds.append((lo, hi))
        lo = hi
    return bounds


class BatchAligner:
    """Scores queries against many targets; backend 'cuda' | 'torch' | 'native'
    ('auto' = 'cuda').

    ``devices``: the torch devices to score on (a list, repeats allowed, or
    one device); None takes them from ``resolve_backend(backend, cards)``:
    the listed CUDA cards, or every visible one."""

    def __init__(
        self,
        scorer,
        mode: str = "SW",
        backend: str = "auto",
        devices=None,
        b_cap: int = 0,
        tail_policy: str = "pow2",
        tail_coalesce: bool = True,
        threads: int = 0,
        resident=None,
        cards=None,
    ):
        if devices is None:
            backend, devices = resolve_backend(backend, cards)
        elif backend == "auto":
            backend = "cuda"
        if not isinstance(devices, (list, tuple)):
            devices = [devices]
        devices = [torch.device(d) for d in devices]
        if not devices:
            raise ValueError("no device to score on")
        kinds = {d.type for d in devices}
        if backend == "cuda" and kinds != {"cuda"}:
            raise ValueError(f"backend cuda needs CUDA devices, got {devices}")
        if backend == "torch" and kinds != {"cpu"}:
            raise ValueError(f"backend torch runs the twin on the CPU, got {devices}")
        if tail_policy not in ("full", "pow2"):
            raise ValueError(f"tail_policy must be 'full' or 'pow2', got {tail_policy!r}")
        self.scorer = scorer
        self.mode = mode
        self.backend = backend
        self.devices = devices
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
        # per device: a launch over n devices may hold n times the groups
        self.scratch_bytes = SCRATCH_BYTES[devices[0].type]
        self.launches = 0
        # device-resident database (align/resident.ResidentDB) or None
        self.resident = resident
        self._matrix32 = {}    # device -> (32, 32) int32 matrix there

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
        for d in self.devices:
            if d not in self._matrix32:
                self._matrix32[d] = matrix32_from_scorer(self.scorer, d)

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
        launches = []
        n_dev = len(self.devices)
        for (n_pad, B), groups in sorted(self._buckets(items).items()):
            g_cap = n_dev * max(1, min(MAX_GROUPS, self.scratch_bytes // (8 * B * n_pad)))
            for gpos in range(0, len(groups), g_cap):
                part = groups[gpos : gpos + g_cap]
                launches.append(self._launch(items, part, n_pad, B, scr_k, smins, native_lib))

        def fetch() -> List[np.ndarray]:
            if not launches:
                return out
            # one device-to-host copy per device: its results in launch order
            per_dev = {}
            for shards, _, _ in launches:
                for sh in shards:
                    per_dev.setdefault(sh.device, []).append(sh.result.reshape(-1))
            flat = {d: torch.cat(parts).cpu().numpy() for d, parts in per_dev.items()}
            pos = dict.fromkeys(flat, 0)
            for shards, part, k_eff in launches:
                for sh in shards:
                    n_g, n_b = sh.g1 - sh.g0, sh.b1 - sh.b0
                    w = k_eff if k_eff else n_b
                    p = pos[sh.device]
                    seg = flat[sh.device][p : p + n_g * w].reshape(n_g, w)
                    pos[sh.device] = p + n_g * w
                    for lg in range(n_g):
                        item_idx, chunk_idx = part[sh.g0 + lg]
                        rows = chunk_idx[sh.b0 : sh.b1]
                        if k_eff:
                            r, sc = decode_screen_words(seg[lg], n_b)
                            out[item_idx][rows[r]] = sc
                        else:
                            out[item_idx][rows] = seg[lg, : len(rows)]
            launches.clear()   # the copies are done: release the host buffers
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

    def _plan(self, G: int, B: int):
        """(device, g0, g1, b0, b1) of each device's share of a (G, B)
        launch: the group axis split over the devices, or, with fewer
        groups than devices, the batch axis (every device all G groups)."""
        n_dev = len(self.devices)
        if G >= n_dev:
            return [(d, g0, g1, 0, B) for d, (g0, g1) in zip(self.devices, _split(G, n_dev))]
        n = min(n_dev, B)
        return [(d, 0, G, b0, b1) for d, (b0, b1) in zip(self.devices, _split(B, n))]

    def _launch(self, items, part, n_pad, B, scr_k, smins, native_lib):
        """Pack one launch's groups into host buffers, one segment per
        device of its split, queue each segment's copy to its device, the
        kernels and the screens; returns (shards, part, k).  The host
        buffers, held by the shards, must live until the fetch: the copies
        from them are asynchronous."""
        G = len(part)
        on_k2 = n_pad >= LONG_RUNG and _long_route(
            (items[i][0].shape[0], _target_lens(items[i][1], idx)) for i, idx in part)
        resident = not on_k2 and self._part_resident(items, part)
        plan = self._plan(G, B)
        batch_split = G < len(self.devices)
        k_eff = min(B, scr_k) if smins is not None and not batch_split else 0
        pin = self.devices[0].type == "cuda"
        # distinct queries of this launch, concatenated
        local_off, local_parts, n_q = {}, [], 0
        for item_idx, _ in part:
            if item_idx not in local_off:
                local_off[item_idx] = n_q
                local_parts.append(items[item_idx][0])
                n_q += items[item_idx][0].shape[0]
        queries = np.concatenate(local_parts) if local_parts else None
        # one int32 host buffer for the small arrays, one segment per
        # device: [lens (Gd*Bd) | q_off (Gd) | q_len (Gd) | smin (Gd) | queries]
        dims = [(g1 - g0, b1 - b0) for _, g0, g1, b0, b1 in plan]
        meta_sizes = [g * b + 3 * g + max(n_q, 1) for g, b in dims]
        tg_sizes = [g * b * (1 if resident else n_pad) for g, b in dims]
        meta_t = torch.zeros(sum(meta_sizes), dtype=torch.int32, pin_memory=pin)
        if resident:
            # (Gd, Bd) int64 starts into the resident tensor; padding rows
            # keep start 0 and length 0
            tg_t = torch.zeros(sum(tg_sizes), dtype=torch.int64, pin_memory=pin)
        else:
            tg_t = torch.empty(sum(tg_sizes), dtype=torch.int8, pin_memory=pin)
        meta, tg_all = meta_t.numpy(), tg_t.numpy()
        if native_lib is None and not resident:
            tg_all.fill(PAD_CODE)
        shards, views, mo, to = [], [], 0, 0
        for (dev, g0, g1, b0, b1), (n_g, n_b), msz, tsz in zip(plan, dims, meta_sizes, tg_sizes):
            shards.append(_Shard(dev, g0, g1, b0, b1, meta_t[mo : mo + msz], tg_t[to : to + tsz]))
            m, o = meta[mo : mo + msz], n_g * n_b
            q_local = m[o + 3 * n_g :]
            q_local[:] = PAD_CODE
            if queries is not None:
                q_local[:n_q] = queries
            shape = (n_g, n_b) if resident else (n_g, n_b, n_pad)
            views.append((m[:o].reshape(n_g, n_b), m[o : o + n_g], m[o + n_g : o + 2 * n_g],
                          m[o + 2 * n_g : o + 3 * n_g], tg_all[to : to + tsz].reshape(shape)))
            mo, to = mo + msz, to + tsz
        for gi, (item_idx, chunk_idx) in enumerate(part):
            targets = items[item_idx][1]
            for sh, (tl, qoff, qlen, smin, tg) in zip(shards, views):
                if not sh.g0 <= gi < sh.g1:
                    continue
                lg = gi - sh.g0
                qoff[lg] = local_off[item_idx]
                qlen[lg] = items[item_idx][0].shape[0]
                if smins is not None:
                    smin[lg] = smins[item_idx]
                rows = chunk_idx[sh.b0 : sh.b1]
                if resident:
                    tg[lg, : len(rows)] = targets.starts[rows]
                    tl[lg, : len(rows)] = targets.lens[rows]
                elif native_lib is not None:
                    # bytes past each length stay uninitialized: the kernel
                    # never reads them and the twin masks them (& 31)
                    if len(rows):
                        _pack_native(native_lib, targets, rows, n_pad, tg[lg], tl[lg])
                else:
                    for r, i in enumerate(rows):
                        t = targets[i]
                        tg[lg, r, : t.shape[0]] = t
                        tl[lg, r] = t.shape[0]

        mesh = [sh.device for sh in shards]
        q_l, go_l, gl_l, sm_l, tg_l, tl_l = [], [], [], [], [], []
        for sh, (tl, _, _, _, tg) in zip(shards, views):
            n_g, n_b = tl.shape
            o = n_g * n_b
            meta_d = sh.meta.to(sh.device, non_blocking=True)
            tg_l.append(sh.targets.to(sh.device, non_blocking=True).view(tg.shape))
            tl_l.append(meta_d[:o].view(n_g, n_b))
            go_l.append(meta_d[o : o + n_g])
            gl_l.append(meta_d[o + n_g : o + 2 * n_g])
            sm_l.append(meta_d[o + 2 * n_g : o + 3 * n_g])
            q_l.append(meta_d[o + 3 * n_g :])
        m32 = [self._matrix32[d] for d in mesh]
        gaps = dict(mode=self.mode, gap_open=self.scorer.gap_open,
                    gap_extend=self.scorer.gap_extend)
        screen = (sm_l,) if k_eff else ()
        scorer = "long" if on_k2 else "grouped"
        if resident:
            fn = make_grouped_resident_sharded(mesh, n_pad=n_pad, screen_k=k_eff, **gaps)
            dbs = [self.resident.on(d) for d in mesh]
            results = fn(q_l, go_l, gl_l, dbs, tg_l, tl_l, m32, *screen)
        else:
            # K2's geometry counts each shard's rows that hold a target and
            # reads its longest query
            k2 = {}
            if on_k2:
                k2 = dict(live_targets=[int(np.count_nonzero(v[0])) for v in views],
                          longest_query=[int(v[2].max(initial=0)) for v in views])
            if batch_split:
                # K2 needs no query bound
                fn = make_grouped_long_sharded(mesh, scorer=scorer, m_cap=None, **gaps)
                results = fn(q_l, go_l, gl_l, tg_l, tl_l, m32, **k2)
            else:
                fn = make_grouped_sharded(mesh, screen_k=k_eff, scorer=scorer, **gaps)
                results = fn(q_l, go_l, gl_l, tg_l, tl_l, m32, *screen, **k2)
        for sh, res in zip(shards, results):
            sh.result = res
        self.launches += 1
        return shards, part, k_eff


class _Shard:
    """One device's share of a launch: groups [g0, g1) x rows [b0, b1),
    its segments of the launch's host buffers (kept alive until the
    fetch) and its result on the device."""

    __slots__ = ("device", "g0", "g1", "b0", "b1", "meta", "targets", "result")

    def __init__(self, device, g0, g1, b0, b1, meta, targets):
        self.device, self.g0, self.g1, self.b0, self.b1 = device, g0, g1, b0, b1
        self.meta, self.targets, self.result = meta, targets, None


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
