"""Interactions trained a second of wall time in the untraced whole epochs
of a traced run: ``train_int_per_s`` where the cell is judged by the
device's time a step, because the host's pace, which sets this rate,
varies too much there from run to run to bound it."""


def read(r):
    w = r.work
    if not w.get("step_wall_s"):
        return None
    return w["batch"] / w["step_wall_s"]
