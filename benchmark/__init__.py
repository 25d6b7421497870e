"""The benchmark of sift4g_tpu_torch: python3 -m benchmark.run (see run.py)."""
