"""sift4g_tpu_torch: the SIFT4G pipeline in PyTorch with CUDA kernels.

A port of ``sift4g_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA H100.
The alignment scorer, the pipeline's only device work, is a hand-written
CUDA kernel in two forms, on target slabs (K1, ``csrc/sw_grouped.cu``)
and on the device-resident database (K3, ``csrc/sw_grouped_resident.cu``),
with plain PyTorch versions (``align/scan.py``).  The host stages (FASTA
streaming, k-mer search, traceback, selection, prediction) are the
package's own copies of the JAX package's framework-free modules, with
their C++ library built by ``native/``.  This package imports neither JAX
nor ``sift4g_tpu``.
"""

__version__ = "0.1.0"
