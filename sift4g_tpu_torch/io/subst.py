"""Substitution (.subst) file parsing and query validation.

Semantics mirror the reference:

* a line "counts" iff it matches ``^([A-Z])([0-9]+)([A-Z])`` anchored at the
  start (regex_search with ^; trailing junk/comments allowed) —
  sift_prediction.cpp:58, sift_scores.cpp:206,252;
* positions are 1-based;
* ``check_query`` mirrors ``checkData``'s per-query validation
  (sift_prediction.cpp:41-142): if the query's subst file exists, the query
  is dropped when the file has zero valid lines, any valid line's position
  is out of bounds, or the reference amino acid mismatches the query.
  Queries without a subst file are always kept (quirk Q11).
"""

from __future__ import annotations

import os
import re
import sys
from typing import List, Optional, Tuple

from ..core.chain import Chain

SUBST_RE = re.compile(r"^([A-Z])([0-9]+)([A-Z])")


def subst_file_name(name: str, subst_dir: str) -> str:
    """Mirror of createFileName(name, dir, ".subst") (utils.cpp:35-50)."""
    if subst_dir:
        return os.path.join(subst_dir, name + ".subst")
    return name + ".subst"


def read_subst_lines(path: str) -> List[str]:
    lines: List[str] = []
    try:
        with open(path, "r") as fh:
            for line in fh:
                lines.append(line.rstrip("\n"))
    except OSError:
        pass
    return lines


def parse_subst_line(line: str) -> Optional[Tuple[str, int, str]]:
    """Return (ref_aa, 1-based position, new_aa) or None."""
    m = SUBST_RE.search(line)
    if not m:
        return None
    return m.group(1), int(m.group(2)), m.group(3)


def check_query(query: Chain, subst_dir: str, log=sys.stderr) -> bool:
    """True iff the query survives checkData (sift_prediction.cpp:55-110)."""
    path = subst_file_name(query.name, subst_dir)
    if not os.path.isfile(path):
        return True
    lines = read_subst_lines(path)
    num_valid = 0
    for line in lines:
        parsed = parse_subst_line(line)
        if parsed is None:
            continue
        num_valid += 1
        ref_aa, pos1, _ = parsed
        pos = pos1 - 1
        if pos >= len(query) or pos < 0:
            print(
                f"* skipping protein [ {query.name} ]: substitution list has a "
                f"position out of bounds (line: {line}, query length = {len(query)}) *",
                file=log,
            )
            return False
        if query.char(pos) != ref_aa:
            print(
                f"* skipping protein [ {query.name} ]: substitution list assumes "
                f"wrong amino acid at position {pos1} (line: {line}, query amino "
                f"acid = {query.char(pos)}) *",
                file=log,
            )
            return False
    if num_valid == 0:
        print(
            f"* skipping protein [ {query.name} ]: substitution list contains "
            "zero valid lines *",
            file=log,
        )
        return False
    return True


def check_data(queries: List[Chain], subst_dir: str, log=sys.stderr) -> List[Chain]:
    """Mirror of checkData: drop invalid queries, preserve order."""
    return [q for q in queries if check_query(q, subst_dir, log=log)]
