"""The card's bound on the SIFT math of device predict.

The work is counted from the plain reference's formulas
(``benchmark/reference/sift.py``), not from how the program computes them
(its one-hot, its padding), so the share reads the same work whatever
implements it.  For a query of L positions whose prepared rows (the query
and its kept alignments) number n, the true cells are n x L:

* each true cell: the raw letter count (an add), the Henikoff term
  1 / (ndiff x count) (a test that the letter counts, a multiply and a
  reciprocal) summed into its row's weight (an add), and the weighted
  count (an add);
* each position, over the 20 valid letters (A) and the 13 components of
  the Dirichlet mixture (C): the distinct-letter count, the total weight,
  the most frequent letter, the epsilon (a rank-weighted mean and an
  exp), the mixture (a log-gamma for each component and letter, for each
  letter's count and each component's total, the log-sum-exp over the
  components, their exp and the alpha-weighted sum), and the blend and the
  two normalisations.

The SIFT math is float arithmetic, so its operations term is the card's
float32 rate: on compute capability 9.0 an SM retires 128 float32 adds,
multiplies or fused multiply-adds a clock, and 16 reciprocals, logs or
exps (CUDA C++ Programming Guide, arithmetic instruction throughput).  A
log-gamma counts as one such special function (it needs at least a log),
a divide as one reciprocal, a fused multiply-add as one instruction, so
the count is a floor.  The bytes term: each true cell's code read once (1
byte) and each position's 26 float32 scores written once, at the card's
HBM bandwidth.  The least time is the largest of the three terms.
"""

from __future__ import annotations

LETTERS = 20  # valid amino acids (the reference's VALID_AA_MASK)
COMPONENTS = 13  # Dirichlet mixture components (DIRI_Q)
SCORES = 26  # float32 scores written a position

FP32_PER_SM_CLOCK = 128
SFU_PER_SM_CLOCK = 16
# H100 SXM5 80 GB: HBM3 at 3.35 TB/s (NVIDIA's datasheet)
HBM_BYTES_PER_S = 3.35e12

# per true cell (create_matrix, calc_seq_weights): the raw count; the
# valid-count test, ndiff x count and the row's sum of the Henikoff
# terms; the weighted count
FP32_PER_CELL = 5
# per true cell: the Henikoff reciprocal
SFU_PER_CELL = 1
BYTES_PER_CELL = 1
BYTES_PER_POSITION = SCORES * 4


def fp32_per_position(a: int = LETTERS, c: int = COMPONENTS) -> int:
    """Adds, multiplies, compares and fused multiply-adds a position."""
    weights = 2 * a + a + a                 # ndiff; the total weight; the most frequent letter
    epsilon = 4 * a                         # valid mask, rank x count, both sums
    mixture = (3 * c + 1                    # total + 1, total + alpha total, probn's start
               + a * (4 * c + 1)            # count + alpha, count + 1, probn's three terms
               + c + 3 * (c - 1) + 2 * c    # log q + probn; log-sum-exp; probj
               + c * a + 2 * a)             # alpha-weighted sum (fused); mask; sum
    blend = a + 1 + a                       # count + eps x diric (fused); total + eps; best letter
    return weights + epsilon + mixture + blend


def sfu_per_position(a: int = LETTERS, c: int = COMPONENTS) -> int:
    """Reciprocals, logs, exps and log-gammas a position."""
    epsilon = 2                             # num / den; exp
    mixture = (1 + c                        # lgamma(total + 1), lgamma(total + alpha total)
               + a * (c + 1)                # lgamma(count + alpha), lgamma(count + 1)
               + 2 * (c - 1) + c            # log-sum-exp's exp and log; exp(probj)
               + a)                         # the mixture's normalisation
    blend = a + a                           # / (total + eps); / the best letter's score
    return epsilon + mixture + blend


def least_seconds(cells: float, positions: float, card: dict) -> dict:
    """The three terms of the least time of ``cells`` true cells over
    ``positions`` positions on ``card`` (SMs and max SM clock, as
    ``bounds.card()`` reads them), and their maximum under ``least``."""
    clock = card["sms"] * card["max_sm_mhz"] * 1e6
    terms = {
        "bytes": (cells * BYTES_PER_CELL + positions * BYTES_PER_POSITION) / HBM_BYTES_PER_S,
        "fp32": (cells * FP32_PER_CELL + positions * fp32_per_position())
        / (FP32_PER_SM_CLOCK * clock),
        "sfu": (cells * SFU_PER_CELL + positions * sfu_per_position())
        / (SFU_PER_SM_CLOCK * clock),
    }
    terms["least"] = max(terms.values())
    return terms


def kernel_seconds_in(trace: dict, phase: str) -> float:
    """The summed time of the device kernels that start inside the host's
    ``phase:<phase>`` ranges (the program's and the harness's ranges of
    one phase nest with the same edges; each kernel counts once)."""
    spans = sorted((s, e) for name, s, e in trace["ranges"] if name == "phase:" + phase)
    total = 0.0
    for _, s, e, is_kernel in trace["device_ops"]:
        if is_kernel and any(a <= s < b for a, b in spans):
            total += e - s
    return total
