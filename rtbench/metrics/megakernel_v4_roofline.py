"""``megakernel_v4``'s share of its roofline: the traced batches' least time
(rtbench.roofline) over the kernel's device time in the trace."""

from rtbench.roofline import kernel_share


def read(run):
    return kernel_share(run, "megakernel_v4")
