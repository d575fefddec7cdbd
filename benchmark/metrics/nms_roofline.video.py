"""Kernel N1's (``csrc/nms.cu``) share of its roofline, %: the least time
of every N1 launch in the traced stretch on the arguments of its public op
``odt::greedy_keep``, its pair count from the reference's greedy keep
mask (``harness/work.py nms_bound_s``), over the device time of the
``nms_keep`` kernels launched there (the driver leaves the bound out
where the two counts differ).

Returns None where the stretch holds no launch of the kernel."""

from benchmark.metrics_common import NMS_KERNEL, kernel_s


def read(obs):
    t = kernel_s(obs, NMS_KERNEL)
    bound = obs.get("nms_bound_s", 0.0)
    if not t or not bound:
        return None
    return 100.0 * bound / t
