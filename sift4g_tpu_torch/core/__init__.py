from .chain import Chain, ChainBatch  # noqa: F401
from .scorers import Scorer, create_scorer, MATRIX_NAMES  # noqa: F401
