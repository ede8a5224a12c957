"""Milliseconds an MPC frame: the window's seconds over its frames."""


def read(rec):
    if rec["kind"] != "mpc":
        return None
    return rec["window_s"] / rec["frames"] * 1e3
