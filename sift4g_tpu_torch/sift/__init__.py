from .select import extract_alignment_strings, alignments_select  # noqa: F401
from .scores import calc_sift_scores, create_matrix  # noqa: F401
