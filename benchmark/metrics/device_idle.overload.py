"""The share of the overloaded serving cell's traced window in which no
device activity ran: 1 - (union of kernel, copy and fill intervals) /
window, in percent."""


def read(r):
    if r.trace is None or r.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - r.trace.busy_s / r.trace.window_s)
