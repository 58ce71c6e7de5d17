"""gat_attn_roofline: the CSR attention kernel's share of its roofline in the
traced window: the least time of the traced passes' attention calls
(``counts_gat.gat_attn_bound_s``: rows, scores and CSR read and the result
written once, or the exponentials and multiply-adds at the f32 rate) over
the device time of every kernel whose name holds ``gat_attn``, in %."""


def read(m):
    if m.trace is None or not hasattr(m.drv, "gat_attn_bound_s"):
        return None
    t = sum(v for k, v in m.trace["kernels"].items() if "gat_attn" in k)
    if t <= 0:
        return None
    return 100.0 * m.trace["calls"] * m.drv.gat_attn_bound_s() / t
