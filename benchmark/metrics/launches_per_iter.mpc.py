"""Kernel launches the device ran in the traced iteration (the profiler's
kernel events, graph replays' kernels included)."""


def read(rec):
    t = rec.get("trace")
    if rec["kind"] != "mpc" or not t or not t["launches"]:
        return None
    return t["launches"]
