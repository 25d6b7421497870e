"""The Smith-Waterman kernels (K1 csrc/sw_grouped.cu and K3
csrc/sw_grouped_resident.cu on the tiled body, K2 csrc/sw_grouped_long.cu,
K1's other accumulators): the least time the window's cells need at the
card's bound (benchmark/bounds.py) over the kernels' summed device time.

The cells are the plain reference's: each window query's length times the
residues of its candidate set, not the program's ``align`` counter, which
under the overlapped schedule also counts candidates scored and evicted."""

SW_KERNELS = ("sw_tiled_kernel", "sw_tiled_f32_kernel", "sw_pair16_kernel", "sw_long_kernel")


def read(run):
    if run.trace is None or run.card is None or not run.ref_cells:
        return None
    t = sum(e - s for name, s, e, k in run.trace["device_ops"]
            if k and any(n in name for n in SW_KERNELS))
    if t <= 0:
        return None
    return 100.0 * run.ref_cells / run.card["sw_cells_per_s"] / t
