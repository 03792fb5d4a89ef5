"""Morton sorts of the wavefront driver (``wavefront.SORTS``) per sample of
every pixel over the traced sub-window."""

from rtbench.metrics._common import per_spp

COUNTERS = ("raytrace2_tpu_torch.ops.kernels.wavefront.SORTS",)


def read(run):
    return per_spp(run, COUNTERS[0])
