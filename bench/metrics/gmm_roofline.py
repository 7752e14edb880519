"""gmm_roofline: of the traced job's expert products, the least time the
card could take counting only the rows that hold a token and each held
expert's weights once (``bench.work.gmm_work``), over the device time of
the grouped-matmul kernels they ran, in %.  Silent where the model has
no experts."""

from bench import work

KERNELS = ("gmm_wide_kernel", "gmm_narrow_kernel", "gmm_f32_kernel")


def read(run):
    bound = sum(work.bound_s(*work.gmm_work(rows, held, D, F, size))
                for rows, held, D, F, size in run.gmm_calls)
    ns = sum(d for name, _, d in run.trace.device_ops
             if any(k in name for k in KERNELS))
    if not bound or not ns:
        return None
    return 100.0 * bound / (ns / 1e9)
