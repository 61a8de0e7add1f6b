"""K2's and K4's share of their roofline, in percent: the least time the
window's decodes need (each packed byte read once, each value written
once, over the card's 3.35 TB/s) over the kernels' summed device time."""

from harness import roofline

KERNELS = ("decode_kernel", "unpack_int_kernel")


def read(run):
    if run.trace is None:
        return None
    seconds = run.trace.kernel_seconds(KERNELS)
    if not seconds:
        return None
    nbytes = run.kernel_bytes["decode"] * run.done()
    return 100 * roofline.bound(nbytes) / seconds
