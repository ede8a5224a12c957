"""The whole solve's share of the card's float64 peak (tensor cores): the
floor on an iteration's operations (``yardstick.work.iteration_flops``)
for the window's instances and iterations, over the window's seconds."""

from benchmark.yardstick import peaks, work


def read(rec):
    if rec["kind"] != "solve":
        return None
    n = rec["batch"] * rec["iterations"] * rec["solves"]
    flops = work.iteration_flops(rec["conf"]) * n
    return 100.0 * flops / rec["window_s"] / peaks.PEAK_FLOP_S_F64_TENSOR
