"""kernel.dual_check_roofline: the dual check's share of its roofline, in
percent: lib/bounds.py's least time for the dual-check work of one job's
reads (candidates and the words they compare, each input byte once,
whatever kernel or route does it) over the device time the traced job
spent in the kernels of csrc/dual_compare.cu (K2 `dual_compare_fetch_kernel`;
K1 `dual_compare_kernel`, on a chunk re-run; K1's rows route
`dual_compare_rows_fused_kernel`).  None when the trace shows none of
them."""

KERNELS = ("dual_compare",)


def read(run):
    seconds = run.kernel_seconds(KERNELS)
    if not seconds:
        return None
    return 100.0 * run.dual_check_work()["bound_s"] / seconds
