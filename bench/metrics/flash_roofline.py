"""flash_roofline: of the traced job's prefill attention, the least time
the card could take (``bench.work.flash_work`` through ``bound_s``,
summed over the calls) over the device time of the kernels they ran, in
%.  Silent where no flash call or no such kernel ran."""

from bench import work

KERNELS = ("flash_fwd_bf16_kernel", "flash_fwd_f32_kernel")


def read(run):
    bound = sum(work.bound_s(*work.flash_work(B, S, T, Hq, Hkv, D, window,
                                              causal, size, Dv))
                for B, S, T, Hq, Hkv, D, Dv, window, causal, size
                in run.flash_calls)
    ns = sum(d for name, _, d in run.trace.device_ops
             if any(k in name for k in KERNELS))
    if not bound or not ns:
        return None
    return 100.0 * bound / (ns / 1e9)
