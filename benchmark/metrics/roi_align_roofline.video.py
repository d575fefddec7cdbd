"""Kernel B1's (``csrc/roi_align.cu``) share of its roofline, %: the least
time of every B1 launch in the traced stretch, from the arguments of its
public op ``odt::multilevel_roi_align`` (``harness/work.py
roi_bound_s``), over the device time of the ``roi_align_fwd`` kernels
launched there (the driver leaves the bound out where the two counts
differ).

Returns None where the stretch holds no launch of the kernel."""

from benchmark.metrics_common import ROI_KERNEL, kernel_s


def read(obs):
    t = kernel_s(obs, ROI_KERNEL)
    bound = obs.get("roi_bound_s", 0.0)
    if not t or not bound:
        return None
    return 100.0 * bound / t
