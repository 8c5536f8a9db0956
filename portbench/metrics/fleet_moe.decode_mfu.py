"""2 x (the rows decoded for requests in the traced stretch) x (the
weights every row multiplies by, plus one expert's weights times the
held experts' token-choices a computed row made, as the program's
``moe.expert_tokens`` counts them on the card over every batch row) over
the stretch's seconds, as a share of the dense bf16 peak.
``fleet.decode_mfu`` counts the same rows with the routed share at its
expected size; the two differ by how far routing leans to or from the
held experts."""
from portbench.counts import BF16_FLOPS


def read(run):
    tr = run.device_trace
    rows = run.counts.get("traced_rows")
    batch_rows = run.counts.get("traced_batch_rows")
    choices = run.counts.get("traced_expert_tokens")
    if tr is None or not rows or not batch_rows or choices is None:
        return None
    per_row = (run.counts["row_params"]
               + choices / batch_rows * run.counts["expert_params"])
    return 100.0 * 2.0 * rows * per_row / tr["window_s"] / BF16_FLOPS
