"""Tokens routed to each held expert per step: the held experts' routed
slots in the window (the program's device counter, read before and
after it), over the held experts of every MoE layer and the steps
completed.  None where the program keeps no such counter."""


def read(run):
    if "moe" not in run.after or "moe" not in run.before:
        return None
    steps = run.record.completed_in_window
    experts = run.after["moe"]["held_experts"]
    if steps == 0 or experts == 0:
        return None
    return run.delta("moe", "held_tokens") / (experts * steps)
