"""iLQR iterations a second: B x iterations x solves completed in the
window, over the window's seconds to the end of its last solve."""

from benchmark.yardstick import phases


def read(rec):
    if rec["kind"] != "solve":
        return None
    return phases.iters_per_s(rec["batch"], rec["iterations"], rec["solves"],
                              rec["window_s"])
