"""Per-query SIFT prediction driver.

Mirrors threadSiftPredictions (sift_prediction.cpp:176-242):

1. keep the first ``MAX_SEQUENCES - 1`` (399) alignment rows (quirk Q7);
2. drop rows >= seq-identity % identical to the query;
3. insert the query itself as row 0;
4. raw count matrix -> SIFT scores;
5. with a .subst file: hash predicted positions, add deleterious reference
   positions, compute median seq info per flagged position, write the
   substitution report; otherwise write the full matrix (quirk Q12).
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

from ..constants import MAX_SEQUENCES, TOLERANCE_PROB_THRESHOLD
from ..core.chain import Chain
from ..io.subst import parse_subst_line, read_subst_lines, subst_file_name
from ..io.writers import (
    create_file_name,
    write_matrix_original_format,
    write_subst_predictions,
)
from .scores import (
    add_median_seq_info,
    calc_sift_scores,
    create_matrix,
    remove_seqs_identical_to_query,
)


def hash_predicted_pos(subst_lines: List[str]) -> Dict[str, float]:
    """hashPredictedPos (sift_scores.cpp:202-216)."""
    median_for_pos: Dict[str, float] = {}
    for line in subst_lines:
        parsed = parse_subst_line(line)
        if parsed is not None:
            median_for_pos[str(parsed[1])] = -1.0
    return median_for_pos


def add_pos_with_del_ref(
    query: Chain, sift_scores: np.ndarray, median_for_pos: Dict[str, float]
) -> None:
    """addPosWithDelRef (sift_scores.cpp:218-231)."""
    for pos in range(sift_scores.shape[0]):
        ref_idx = int(query.codes[pos])
        if sift_scores[pos, ref_idx] < TOLERANCE_PROB_THRESHOLD:
            key = str(pos + 1)
            if key not in median_for_pos:
                median_for_pos[key] = -1.0


def prepare_rows(
    query: Chain, names: List[str], rows: np.ndarray, sequence_identity: int
) -> np.ndarray:
    """Shared preprocessing of threadSiftPredictions (:183-197): Q7 cap at
    399 rows, sequence-identity filter, query inserted as row 0.  Returns
    the (n, L) code rows the scoring math runs on."""
    if rows.shape[0] > MAX_SEQUENCES - 1:
        rows = rows[: MAX_SEQUENCES - 1]
        names = names[: MAX_SEQUENCES - 1]
    names, rows = remove_seqs_identical_to_query(
        query.codes, names, rows, float(sequence_identity)
    )
    if rows.size:
        return np.vstack([query.codes[None, :], rows])
    return query.codes[None, :].copy()


def predict_prepared(
    query: Chain,
    rows: np.ndarray,
    subst_lines,  # Optional[List[str]]: None = matrix mode
    out_path: str,
) -> None:
    """Prediction for one query from already-prepared rows (the float64
    oracle path).  Shared by the per-query host driver and the hybrid
    device path's full-query fallback (predict_subst.py)."""
    total_seq = rows.shape[0]
    raw_matrix, aas_stored = create_matrix(rows, np.ones(total_seq))
    sift_scores, _, _ = calc_sift_scores(rows, raw_matrix)

    if subst_lines is not None:
        median_for_pos = hash_predicted_pos(subst_lines)
        add_pos_with_del_ref(query, sift_scores, median_for_pos)
        add_median_seq_info(rows, median_for_pos)
        write_subst_predictions(
            subst_lines, median_for_pos, sift_scores, aas_stored,
            total_seq, query, out_path,
        )
    else:
        write_matrix_original_format(sift_scores, out_path)


def predict_query(
    query: Chain,
    names: List[str],
    rows: np.ndarray,
    subst_dir: str,
    sequence_identity: int,
    out_dir: str,
) -> None:
    """Run prediction for one query and write its output file."""
    rows = prepare_rows(query, names, rows, sequence_identity)
    subst_path = subst_file_name(query.name, subst_dir)
    predict_prepared(
        query,
        rows,
        read_subst_lines(subst_path) if os.path.isfile(subst_path) else None,
        create_file_name(query.name, out_dir, ".SIFTprediction"),
    )
