from .fasta import read_fasta, FastaStream  # noqa: F401
