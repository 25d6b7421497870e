"""Build the port's native library: python -m sift4g_tpu_torch.native

Builds ``sift4g_tpu_torch/native/*.cpp`` into ``sift4g_tpu_torch/_build/``
(once; an unchanged build loads at once) and prints whether it loads.  A
failed build raises, as the loader does; with ``SIFT4G_TPU_NO_NATIVE``
set nothing is loaded and the exit status is 1."""

import sys

from . import library_path, load

if __name__ == "__main__":
    ok = load() is not None
    print("native library:", f"built and loadable ({library_path()})" if ok
          else "not loaded (SIFT4G_TPU_NO_NATIVE is set)")
    sys.exit(0 if ok else 1)
