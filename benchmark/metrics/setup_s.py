"""End to end: the set-up, from the harness's start to the window's:
imports, generating the inputs, the kernels' library (built in a
checkout's first run), the CUDA context and one warm-up job of the cell's
own traffic, which builds the parse cache and, where ``auto`` takes it,
the resident database."""


def read(run):
    return run.setup_s
