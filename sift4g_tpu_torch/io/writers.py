"""Output writers: .SIFTprediction, aligned.fasta, and alignment reports.

Format fidelity targets (reference citations):

* ``write_matrix_original_format`` — sift_scores.cpp:597-626 (quirk Q12):
  header ``ID   UNK_ID; MATRIX`` etc., columns A..Z minus J/O/U, then
  literal ``*`` and ``-`` columns of 0.0000, ``//`` trailer, cells printed
  as `` %6.4f ``.
* ``write_subst_predictions`` — sift_scores.cpp:247-314: WARNING lines for
  deleterious reference positions with inadequate median info (including
  the reference's 0-based-key lookup bug, quirk Q2), then one line per
  valid subst entry: ``SUB\\tTOLERATED|DELETERIOUS\\tscore\\tmedian\\t
  n_seqs\\ttotal_seq`` with 2-decimal fixed formatting.
* ``write_selected_alignments`` — select_alignments.cpp:76-110: query
  renamed ``>QUERY``, 60-char wrapping with the reference's trailing
  newline behaviour.
* ``write_alignments_report`` — swsharp ``outputShotgunDatabase`` formats
  bm0/bm8/bm9/light (main.cpp:44-49,340-346).  swsharp's exact renderer is
  absent from the snapshot; bm8/bm9 follow standard BLAST tabular
  conventions, ``light`` is score-name pairs, and bm0 renders the classic
  BLAST m0 pairwise report: per-target ``Score/Expect`` + ``Identities/
  Positives/Gaps`` stanzas followed by 60-column Query/midline/Sbjct
  blocks with 1-based residue coordinates (gaps do not advance them) and
  the NCBI midline convention — the letter on identity, ``+`` on a
  positive substitution score, blank otherwise.
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict, List, Sequence

import numpy as np

from ..constants import ADEQUATE_SEQ_INFO, TOLERANCE_PROB_THRESHOLD
from ..core.chain import Chain
from .subst import parse_subst_line

_SKIP_COLS = (9, 14, 20)  # J, O, U


_TMP_SEQ = __import__("itertools").count()


@contextlib.contextmanager
def atomic_output(path: str, mode: str = "w"):
    """Write to ``path`` atomically: a temp file in the same directory is
    os.replace()d into place on success and unlinked on failure, so a
    crash mid-write can never leave a truncated file under the final name.
    ``--resume`` (pipeline.py) relies on this: an existing output IS a
    complete output.  The pid suffix keeps concurrent writers (multi-host
    processes sharing --out) apart; the sequence number keeps SAME-process
    concurrent writers to one path apart (duplicate query names write
    from pool threads — last replace wins atomically, the reference's
    last-writer-wins semantics without interleaving)."""
    tmp = f"{path}.tmp.{os.getpid()}.{next(_TMP_SEQ)}"
    fp = open(tmp, mode)
    try:
        yield fp
    except BaseException:
        fp.close()
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    fp.close()
    os.replace(tmp, path)


def create_file_name(name: str, out_dir: str, extension: str) -> str:
    """Mirror of createFileName (utils.cpp:35-50)."""
    if out_dir:
        return os.path.join(out_dir, name + extension)
    return name + extension


def _fmt2(x: float) -> str:
    return f"{x:.2f}"


_KEEP_COLS = [c for c in range(26) if c not in _SKIP_COLS]
_MATRIX_HEADER = (
    "ID   UNK_ID; MATRIX\nAC   UNK_AC\nDE   UNK_DE\nMA   UNK_BL\n "
    + "".join(f" {chr(c + ord('A'))}  " for c in _KEEP_COLS)
    + " *   -\n"
)
# one C-level %-format per POSITION line ("%6.4f" % v is byte-identical
# to f"{v:6.4f}"): at missense scale the previous per-cell f-string
# writes (L x 23 x 20k queries) dominated the device-predict phase
_MATRIX_LINE_FMT = " %6.4f " * len(_KEEP_COLS) + " 0.0000  0.0000\n"


def write_matrix_original_format(matrix: np.ndarray, path: str) -> None:
    """matrix: (L, 26) float64 SIFT scores."""
    body = matrix[:, _KEEP_COLS]
    text = (_MATRIX_LINE_FMT * body.shape[0]) % tuple(body.ravel())
    with atomic_output(path) as fp:
        fp.write(_MATRIX_HEADER + text + "//\n")


def write_subst_predictions(
    subst_lines: Sequence[str],
    median_for_pos: Dict[str, float],
    sift_scores: np.ndarray,
    aas_stored: np.ndarray,
    total_seq: int,
    query: Chain,
    path: str,
) -> None:
    """Mirror of printSubstFile (sift_scores.cpp:247-314).

    ``median_for_pos`` keys are 1-based position strings; this function
    replicates the reference's operator[] lookups on the 0-based key
    (quirk Q2) including the default-insertion side effect.
    """
    query_length = sift_scores.shape[0]
    out = []
    for pos in range(query_length):
        ref_aa = query.char(pos)
        ref_idx = ord(ref_aa) - ord("A")
        if sift_scores[pos, ref_idx] < TOLERANCE_PROB_THRESHOLD:
            key1 = str(pos + 1)
            if key1 not in median_for_pos:
                continue
            median = median_for_pos[key1]
            if median < ADEQUATE_SEQ_INFO:
                # operator[] on the 0-based key default-inserts 0.0 (Q2)
                key0 = str(pos)
                wrong_median = median_for_pos.setdefault(key0, 0.0)
                out.append(
                    f"WARNING! {ref_aa}{pos + 1} not allowed! score: "
                    f"{_fmt2(sift_scores[pos, ref_idx])} median: {_fmt2(wrong_median)} "
                    f"# of sequence: {int(aas_stored[pos])}"
                )
    for line in subst_lines:
        parsed = parse_subst_line(line)
        if parsed is None:
            continue
        clean = line.split()[0] if line.split() else ""
        ref_aa, pos1, new_aa = parsed
        pos = pos1 - 1
        new_idx = ord(new_aa) - ord("A")
        score = sift_scores[pos, new_idx]
        if query.char(pos) != ref_aa:
            out.append(
                f"WARNING! Amino acid {query.char(pos)} is at position {pos1}, "
                f"but your list of substitutions assumes it's a {ref_aa}"
            )
        label = "TOLERATED" if score >= TOLERANCE_PROB_THRESHOLD else "DELETERIOUS"
        median = median_for_pos[str(pos1)]
        out.append(
            f"{clean}\t{label}\t{_fmt2(score)}\t{_fmt2(median)}\t"
            f"{int(aas_stored[pos])}\t{total_seq}"
        )
    with atomic_output(path) as fp:
        for line in out:
            fp.write(line + "\n")


def _write_wrapped(fp, seq: str) -> None:
    """60-char wrapping with the reference's newline behaviour
    (select_alignments.cpp:91-95): newline after every 60 chars AND a final
    newline — a length that is a multiple of 60 produces a blank line."""
    for j in range(1, len(seq) + 1):
        fp.write(seq[j - 1])
        if j % 60 == 0:
            fp.write("\n")
    fp.write("\n")


def write_selected_alignments(
    alignment_strings: List[List[Chain]],
    queries: List[Chain],
    out_dir: str,
) -> None:
    """Mirror of outputSelectedAlignments (select_alignments.cpp:76-110)."""
    for i, query in enumerate(queries):
        path = create_file_name(query.name, out_dir, ".aligned.fasta")
        with atomic_output(path) as fp:
            fp.write(">QUERY\n")
            _write_wrapped(fp, query.letters)
            for aln in alignment_strings[i]:
                fp.write(f">{aln.name}\n")
                _write_wrapped(fp, aln.letters)


def _write_blast_m0(fp, query: Chain, rec, matrix: np.ndarray) -> None:
    """One BLAST m0 pairwise stanza (swsharp outputDatabase's ``bm0``)."""
    q_str, t_str = rec.render_strings()
    n = len(q_str)
    idents = positives = gaps = 0
    mid = []
    for qc, tc in zip(q_str, t_str):
        if qc == "-" or tc == "-":
            gaps += 1
            mid.append(" ")
        elif qc == tc:
            idents += 1
            positives += 1
            mid.append(qc)
        elif matrix[ord(qc) - ord("A"), ord(tc) - ord("A")] > 0:
            positives += 1
            mid.append("+")
        else:
            mid.append(" ")
    midline = "".join(mid)

    fp.write(f">{rec.target_name}\n")
    fp.write(f"Length={len(rec.target_codes)}\n\n")
    fp.write(f" Score = {rec.score},  Expect = {rec.evalue:.2g}\n")

    def pct(x: int) -> int:
        return int(round(100.0 * x / n)) if n else 0

    fp.write(
        f" Identities = {idents}/{n} ({pct(idents)}%), "
        f"Positives = {positives}/{n} ({pct(positives)}%), "
        f"Gaps = {gaps}/{n} ({pct(gaps)}%)\n\n"
    )

    width = max(len(str(rec.query_end + 1)), len(str(rec.target_end + 1)))
    qpos, tpos = rec.query_start, rec.target_start  # 0-based next residue
    for off in range(0, n, 60):
        qb, tb, mb = q_str[off:off + 60], t_str[off:off + 60], midline[off:off + 60]
        q_adv = sum(c != "-" for c in qb)
        t_adv = sum(c != "-" for c in tb)
        # 1-based block coordinates; an all-gap block repeats the previous
        # residue coordinate on both ends (NCBI behaviour)
        q_from = qpos + 1 if q_adv else qpos
        t_from = tpos + 1 if t_adv else tpos
        qpos += q_adv
        tpos += t_adv
        fp.write(f"Query  {q_from:<{width}}  {qb}  {qpos}\n")
        fp.write(f"       {'':{width}}  {mb}\n")
        fp.write(f"Sbjct  {t_from:<{width}}  {tb}  {tpos}\n\n")
    fp.write("\n")


def write_alignments_report(
    alignments_per_query,  # List[List[AlignmentRecord]]
    queries: List[Chain],
    path: str,
    out_format: str,
    scorer=None,
) -> None:
    """Alignment report in bm0/bm8/bm9/light format (main.cpp:44-49).

    ``scorer`` feeds the bm0 midline's Positives test (positive
    substitution score); BLOSUM_62 when omitted."""
    if out_format == "bm0":
        if scorer is None:
            from ..core.scorers import create_scorer

            scorer = create_scorer("BLOSUM_62")
        m0_matrix = scorer.matrix
    with atomic_output(path) as fp:
        for qi, query in enumerate(queries):
            alns = alignments_per_query[qi]
            if out_format == "bm0":
                fp.write(f"Query= {query.name}\n\nLength={len(query)}\n\n")
            if out_format == "bm9":
                fp.write(f"# Query: {query.name}\n")
                fp.write(
                    "# Fields: Query id, Subject id, % identity, alignment "
                    "length, mismatches, gap openings, q. start, q. end, "
                    "s. start, s. end, e-value, score\n"
                )
            for rec in alns:
                if out_format == "light":
                    fp.write(f"{rec.score}\t{rec.target_name}\n")
                elif out_format in ("bm8", "bm9"):
                    fp.write(
                        f"{query.name}\t{rec.target_name}\t{rec.identity_pct:.2f}\t"
                        f"{rec.path_len}\t{rec.mismatches}\t{rec.gap_openings}\t"
                        f"{rec.query_start + 1}\t{rec.query_end + 1}\t"
                        f"{rec.target_start + 1}\t{rec.target_end + 1}\t"
                        f"{rec.evalue:.2e}\t{rec.score}\n"
                    )
                else:  # bm0: BLAST m0 pairwise stanzas
                    _write_blast_m0(fp, query, rec, m0_matrix)
