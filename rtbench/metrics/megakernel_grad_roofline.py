"""``megakernel_grad``'s (the replay backward's) share of its roofline: the
traced steps' least time with each segment's adjoint (rtbench.roofline)
over the kernel's device time in the trace."""

from rtbench.roofline import kernel_share


def read(run):
    return kernel_share(run, "megakernel_grad", adjoint=True)
