"""Peak device memory over set-up and window
(``torch.cuda.max_memory_allocated``), in GiB: what decides the batch a
card holds."""


def read(rec):
    if not rec["peak_bytes"]:
        return None
    return rec["peak_bytes"] / 2 ** 30
