"""The plain reference: SIFT4G from a database and queries to the text of
each query's .SIFTprediction file.

Independent of the program: it imports no module of ``sift4g_tpu_torch``,
``sift4g_tpu`` or JAX (``benchmark/run.py`` checks its sources in every
run) and reads only the inputs the benchmark generated, never what the
program derived from them.  Stages, each frozen at commit eca6a4da from
the program's plain versions: the k-mer prefilter (``prefilter.py``), the
Smith-Waterman scores and tracebacks (``sw.py``), the E-value screen
(``evalue.py``), then selection and prediction (``sift.py``).
"""

from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from . import evalue, prefilter, sift, sw
from .tables import BLOSUM62, GAPPED_BLOSUM62_10_1

# bound the device memory of one reference pass (columns of a score batch;
# bytes of a traceback's per-cell flags)
SCORE_COLUMNS = 48_000_000
FLAG_BYTES = 1_500_000_000


def _check_params(params: dict) -> None:
    want = {"matrix": "BLOSUM_62", "gap_open": 10, "gap_extend": 1, "algorithm": "SW"}
    for k, v in want.items():
        if params[k] != v:
            raise ValueError(f"the reference holds {k}={v!r} only, not {params[k]!r}")


class Reference:
    """The database's k-mers on ``device``, ready for queries."""

    def __init__(self, db_codes: np.ndarray, db_offsets: np.ndarray, params: dict, device):
        _check_params(params)
        self.params = params
        self.device = device
        self.codes = db_codes
        self.offsets = db_offsets
        self.db = prefilter.Database(db_codes, db_offsets, params["kmer_length"], device)
        self.ev = evalue.EValueParams(*GAPPED_BLOSUM62_10_1, total_cells=self.db.total_residues)
        self.cells = {}   # candidate cells of each query :meth:`predictions` saw
        self.times = {}   # seconds of each stage of the last :meth:`predictions`

    def target(self, i: int) -> np.ndarray:
        return self.codes[self.offsets[i]:self.offsets[i + 1]]

    def candidates(self, queries: Sequence[np.ndarray]) -> List[np.ndarray]:
        return prefilter.candidates(self.db, list(queries), self.params["max_candidates"])

    def candidate_cells(self, queries: Dict[str, np.ndarray]) -> int:
        """Sum over the queries of |q| x |t| over their candidate sets: the
        cells the align layer has to score.  Queries that
        :meth:`predictions` saw are not searched again."""
        lens = np.diff(self.offsets)
        new = [n for n in queries if n not in self.cells]
        for n, c in zip(new, self.candidates([queries[n] for n in new])):
            self.cells[n] = queries[n].shape[0] * int(lens[c].sum())
        return sum(self.cells[n] for n in queries)

    def _packed(self, ids: np.ndarray):
        """(codes end to end, lengths) of database records ``ids``."""
        lens = np.diff(self.offsets)[ids]
        starts = self.offsets[ids]
        idx = np.repeat(starts - (np.cumsum(lens) - lens), lens) + np.arange(int(lens.sum()))
        return self.codes[idx], lens

    def _scores(self, queries: List[np.ndarray], cands: List[np.ndarray]) -> List[np.ndarray]:
        """SW scores of every candidate, queries batched by length."""
        lens = np.diff(self.offsets)
        out: List[np.ndarray] = [None] * len(queries)
        order = sorted(range(len(queries)), key=lambda i: queries[i].shape[0])
        batch, cols = [], 0
        for i in order + [None]:
            w = 0 if i is None else int(lens[cands[i]].sum()) + cands[i].shape[0]
            if batch and (i is None or cols + w > SCORE_COLUMNS):
                ids = np.concatenate([cands[qi] for qi in batch])
                owner = np.repeat(np.arange(len(batch)), [cands[qi].shape[0] for qi in batch])
                s = sw.scores([queries[qi] for qi in batch], self._packed(ids), owner, BLOSUM62,
                              self.params["gap_open"], self.params["gap_extend"], self.device)
                bounds = np.cumsum([0] + [cands[qi].shape[0] for qi in batch])
                for k, qi in enumerate(batch):
                    out[qi] = s[bounds[k]:bounds[k + 1]]
                batch, cols = [], 0
            if i is not None:
                batch.append(i)
                cols += w
        return out

    def _kept(self, query: np.ndarray, ids: np.ndarray, scores: np.ndarray) -> np.ndarray:
        """The E-value screen and the cap: ids by (score desc, id asc)."""
        ev = evalue.evalues(scores, query.shape[0], self.ev)
        keep = np.flatnonzero(ev <= self.params["evalue"])
        keep = keep[np.lexsort((ids[keep], -scores[keep]))][: self.params["max_aligns"]]
        return ids[keep]

    def _records(self, queries: List[np.ndarray], kept: List[np.ndarray]):
        """Each query's (query_start, target_start, moves, target codes),
        best first; queries batched by length under the flag budget."""
        lens = np.diff(self.offsets)
        out = [[] for _ in queries]
        order = sorted(range(len(queries)), key=lambda i: queries[i].shape[0])
        batch, cols = [], 0
        for i in order + [None]:
            w = 0 if i is None else int(lens[kept[i]].sum()) + kept[i].shape[0]
            rows = 0 if i is None else queries[i].shape[0]
            if batch and (i is None or (cols + w) * rows > FLAG_BYTES):
                ids = np.concatenate([kept[qi] for qi in batch])
                owner = np.repeat(np.arange(len(batch)), [kept[qi].shape[0] for qi in batch])
                recs = sw.align([queries[qi] for qi in batch], self._packed(ids), owner, BLOSUM62,
                                self.params["gap_open"], self.params["gap_extend"], self.device)
                for t, o, (_, qs, ts, moves) in zip(ids, owner, recs):
                    out[batch[o]].append((qs, ts, moves, self.target(int(t))))
                batch, cols = [], 0
            if i is not None:
                batch.append(i)
                cols += w
        return out

    def predictions(self, queries: Dict[str, np.ndarray], subst_dir: str,
                    lower=(False,)) -> Dict[bool, Dict[str, Optional[str]]]:
        """{lower: {query name: .SIFTprediction text, or None for no file}};
        ``lower`` True is the control (``sift.prediction``)."""
        names, codes, substs = [], [], []
        out = {lw: {} for lw in lower}
        for name, q in queries.items():
            lines = None
            if subst_dir:
                path = os.path.join(subst_dir, name + ".subst")
                if os.path.isfile(path):
                    lines = sift.read_subst_lines(path)
                    if not sift.subst_valid(q, lines):
                        for lw in lower:
                            out[lw][name] = None  # checkData drops the query
                        continue
            names.append(name)
            codes.append(q)
            substs.append(lines)
        t = time.perf_counter()
        cands = self.candidates(codes)
        self.cells = {n: q.shape[0] * int(np.diff(self.offsets)[c].sum())
                      for n, q, c in zip(names, codes, cands)}
        self.times["candidates"] = time.perf_counter() - t
        scores = self._scores(codes, cands)
        self.times["scores"] = time.perf_counter() - t - self.times["candidates"]
        kept = [self._kept(q, c, s) for q, c, s in zip(codes, cands, scores)]
        t = time.perf_counter()
        records = self._records(codes, kept)
        self.times["tracebacks"] = time.perf_counter() - t
        t = time.perf_counter()

        def one(k):
            rows = sift.alignment_rows(codes[k].shape[0], records[k])
            return [sift.prediction(codes[k], rows, substs[k], self.params["median_threshold"],
                                    float(self.params["seq_id"]), lw) for lw in lower]

        with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as ex:
            for name, texts in zip(names, ex.map(one, range(len(names)))):
                for lw, text in zip(lower, texts):
                    out[lw][name] = text
        self.times["predict"] = time.perf_counter() - t
        return out

    def close(self) -> None:
        del self.db
        if str(self.device).startswith("cuda"):
            torch.cuda.empty_cache()
