"""Set-up seconds: from the start of the process to the start of the
window (imports, the CUDA context, the model, the kernel library's build or
load, the seeded inputs and the warm-up iteration with its CUDA-graph
captures)."""


def read(rec):
    return rec["setup_s"]
