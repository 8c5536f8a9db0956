"""2 N (rows decoded for completed requests) over the traced stretch's
seconds, as a share of the dense bf16 peak (N: parameters less the
embedding table)."""
from portbench.counts import BF16_FLOPS


def read(run):
    tr = run.device_trace
    rows = run.counts.get("traced_rows")
    if tr is None or not rows:
        return None
    flops = 2.0 * run.counts["matmul_params"] * rows
    return 100.0 * flops / tr["window_s"] / BF16_FLOPS
