"""Published peaks of one NVIDIA H100 SXM at its 700 W limit (NVIDIA's data
sheet, dense rates).

``PEAK_BYTES_S`` and ``PEAK_FLOP_S_F64`` are copied from the program's
``utils/profiling.py`` (``PEAK_BYTES_S``, ``PEAK_FLOP_S[torch.float64]``);
the float64 rate there is the one outside the tensor cores.  A share of the
whole solve's peak is taken against ``PEAK_FLOP_S_F64_TENSOR``, the float64
tensor-core rate, the highest float64 rate the card has.
"""

PEAK_BYTES_S = 3.35e12            # HBM3
PEAK_FLOP_S_F64 = 34e12           # float64, outside the tensor cores
PEAK_FLOP_S_F64_TENSOR = 67e12    # float64 on the tensor cores
