"""Coded calls completed inside the measured window, over the window."""


def read(run):
    rec = run.record
    if rec.window_s <= 0 or rec.completed_in_window == 0:
        return None
    return rec.completed_in_window / rec.window_s
