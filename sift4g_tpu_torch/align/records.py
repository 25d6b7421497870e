"""Alignment records: score + coordinates + edit path.

Move semantics match the reference's replay in ``aligmentStr``
(select_alignments.cpp:244-300): MOVE_LEFT consumes a target residue (gap
in query), MOVE_UP consumes a query residue (gap in target), MOVE_DIAG
consumes both.  The path runs from (query_start, target_start) forward.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

MOVE_DIAG = 0
MOVE_LEFT = 1  # gap in query, consumes target
MOVE_UP = 2    # gap in target, consumes query


@dataclass
class AlignmentRecord:
    score: int
    query_start: int
    query_end: int     # inclusive
    target_start: int
    target_end: int    # inclusive
    moves: np.ndarray  # uint8 array of MOVE_*
    target_idx: int = -1          # global database index
    target_name: str = ""
    evalue: float = float("inf")
    query_codes: np.ndarray = field(default=None, repr=False)
    target_codes: np.ndarray = field(default=None, repr=False)

    @property
    def path_len(self) -> int:
        return int(self.moves.shape[0])

    def render_strings(self, gap_item: str = "-"):
        """Query/target strings over the path (mirror of aligmentStr)."""
        qi, ti = self.query_start, self.target_start
        q_chars, t_chars = [], []
        for mv in self.moves:
            if mv == MOVE_LEFT:
                q_chars.append(gap_item)
                t_chars.append(chr(int(self.target_codes[ti]) + ord("A")))
                ti += 1
            elif mv == MOVE_UP:
                q_chars.append(chr(int(self.query_codes[qi]) + ord("A")))
                t_chars.append(gap_item)
                qi += 1
            else:
                q_chars.append(chr(int(self.query_codes[qi]) + ord("A")))
                t_chars.append(chr(int(self.target_codes[ti]) + ord("A")))
                qi += 1
                ti += 1
        return "".join(q_chars), "".join(t_chars)

    @property
    def identity_pct(self) -> float:
        if self.path_len == 0:
            return 0.0
        matches = 0
        qi, ti = self.query_start, self.target_start
        for mv in self.moves:
            if mv == MOVE_DIAG:
                if self.query_codes[qi] == self.target_codes[ti]:
                    matches += 1
                qi += 1
                ti += 1
            elif mv == MOVE_LEFT:
                ti += 1
            else:
                qi += 1
        return 100.0 * matches / self.path_len

    @property
    def mismatches(self) -> int:
        n = 0
        qi, ti = self.query_start, self.target_start
        for mv in self.moves:
            if mv == MOVE_DIAG:
                if self.query_codes[qi] != self.target_codes[ti]:
                    n += 1
                qi += 1
                ti += 1
            elif mv == MOVE_LEFT:
                ti += 1
            else:
                qi += 1
        return n

    @property
    def gap_openings(self) -> int:
        n = 0
        prev = MOVE_DIAG
        for mv in self.moves:
            if mv != MOVE_DIAG and mv != prev:
                n += 1
            prev = mv
        return n
