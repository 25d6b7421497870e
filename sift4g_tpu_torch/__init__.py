"""sift4g_tpu_torch: the SIFT4G pipeline in PyTorch with CUDA kernels.

A port of ``sift4g_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA H100.
The alignment scorer, the pipeline's only device work, is a hand-written
CUDA kernel (``csrc/sw_grouped.cu``) with a plain PyTorch twin
(``align/scan.py``); the host stages (FASTA streaming, k-mer search,
traceback, selection, prediction) are the JAX package's framework-free
modules, imported rather than copied.  This package never imports JAX.
"""

__version__ = "0.1.0"
