"""The Riccati kernel's share of its roofline: the least time of one launch
at the cell's shapes (its bytes over the HBM rate, or its operations over
the float64 rate outside the tensor cores, whichever is larger) over the
kernel's device time per launch in the traced iteration."""

from benchmark.yardstick import peaks, work


def read(rec):
    t = rec.get("trace")
    if rec["kind"] != "solve" or not t or not t["riccati_launches"]:
        return None
    c = rec["conf"]
    ops, nbytes = work.riccati_work(rec["batch"], c["horizon"], 2 * c["nv"],
                                    8 if c["dtype"] == "float64" else 4)
    bound = max(nbytes / peaks.PEAK_BYTES_S, ops / peaks.PEAK_FLOP_S_F64)
    return 100.0 * bound / (t["riccati_s"] / t["riccati_launches"])
