"""Milliseconds of the backward phase of one iteration of the cell's solve,
called alone and fenced by CUDA events (the traced iteration)."""


def read(rec):
    if rec["kind"] != "solve" or "trace" not in rec:
        return None
    return rec["trace"]["phase_ms"].get("backward")
