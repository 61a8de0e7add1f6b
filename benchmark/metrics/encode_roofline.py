"""K1's, K3's and K5's share of their roofline, in percent: the least
time the window's encodes need (each value read once, each packed byte
written once, over the card's 3.35 TB/s) over the summed device time of
all their launches (stats, plan and pack)."""

from harness import roofline

KERNELS = ("stats_init_kernel", "stats_kernel", "plan_kernel",
           "pack_tiles_kernel", "int_stats_init_kernel", "int_stats_kernel",
           "int_plan_kernel", "pack_int_kernel")


def read(run):
    if run.trace is None:
        return None
    seconds = run.trace.kernel_seconds(KERNELS)
    if not seconds:
        return None
    nbytes = run.kernel_bytes["encode"] * run.done()
    return 100 * roofline.bound(nbytes) / seconds
