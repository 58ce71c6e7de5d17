"""spmm_roofline: the SpMM kernel's share of its roofline in the traced
window: the least time of the traced passes' SpMMs (``counts.spmm_bound_s``,
bytes read and written once) over the device time of every kernel whose
name holds ``spmm``, in %."""


def read(m):
    if m.trace is None or not hasattr(m.drv, "spmm_bound_s"):
        return None
    t = sum(v for k, v in m.trace["kernels"].items() if "spmm" in k)
    if t <= 0:
        return None
    return 100.0 * m.trace["calls"] * m.drv.spmm_bound_s() / t
