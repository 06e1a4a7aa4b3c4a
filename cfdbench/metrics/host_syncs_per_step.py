"""host_syncs_per_step (syncs/step): the program's ``yofc:sync.*`` spans in
the traced chunks, over their coupled steps: each is one point where the
host waits for the card, CG's exit reads (``yofc:sync.cg_exit``) and the
blocking copies of host data to the card (``yofc:sync.h2d``). A count,
read from a run on the card (without one nothing waits). Layer: the step
loop (`models/coupled`: `make_scan_fn`, `coupled_step`).

The targets are the program's own span names, which import no module: the
harness wraps nothing for them and keeps their ranges."""

STEP = "yofc:step"
SYNCS = ("yofc:sync.cg_exit", "yofc:sync.h2d")
WRAPS = (STEP,) + SYNCS


def read(trace):
    if not trace.device_ops or not trace.calls(STEP) or not trace.steps:
        return None         # no card, or a program without spans
    return sum(trace.calls(s) for s in SYNCS) / trace.steps
