"""The device's idle share of the traced iteration, in %: 1 minus the union
of the device operations' intervals over the iteration's host seconds."""


def read(rec):
    t = rec.get("trace")
    if rec["kind"] != "mpc" or not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
