"""The program's own count of CG-iteration graph replays
(``physics/solver._GRAPHS.replays``) over the window, per iteration of the
window's solves (each solve's initial rollout included)."""


def read(rec):
    if rec["kind"] != "solve":
        return None
    return rec["cg_replays"] / (rec["solves"] * rec["iterations"])
