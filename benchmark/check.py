"""The check that decides a run's ``correct``: what the timed path produced,
compared with the plain reference on the same seeded inputs.

Each number is a widest gap over the compared answers, relative to the
reference's own scale, so that it reads the same on the cart-pole and the
humanoid: :func:`relative` for a cost trace (|c - c_ref| / |c_ref|, every
iteration) or a regularisation, :func:`widest` for a trajectory (max
|x - x_ref| over max(1, max |x_ref|) per instance and field) or for gains
(max |K - K_ref| over max |K_ref| per instance).  Which numbers a traffic
kind has is in ``kinds/<kind>.py`` (``numbers``).

Where both sides are NaN at the same place (an instance that diverged on
both) the gap is 0; NaN on one side only is an infinite gap.  Each
number's ``limit`` is in ``checks/<cell>.json``, beside the ``lower``
reading (the largest of sound runs) and the ``upper`` one (the smallest of
the float32 control) that it was set between; the cell compares the
numbers given a limit there.
"""

from __future__ import annotations

import math

import torch

TINY = torch.finfo(torch.float64).tiny


def _gap(a: torch.Tensor, b: torch.Tensor, scale: torch.Tensor):
    a, b = a.double().cpu(), b.double().cpu()
    d = (a - b).abs()
    both = torch.isnan(a) & torch.isnan(b)
    d = torch.where(both, torch.zeros_like(d), d)
    d = torch.where(torch.isnan(d), torch.full_like(d, math.inf), d)
    return d / scale


def _per_instance_scale(ref: torch.Tensor, floor: float) -> torch.Tensor:
    r = ref.double().cpu().abs().nan_to_num(0.0)
    m = r.reshape(r.shape[0], -1).amax(-1) if r.numel() else r
    m = torch.clamp(m, min=floor)
    return m.reshape((-1,) + (1,) * (ref.dim() - 1))


def widest(a: torch.Tensor, b: torch.Tensor, floor: float) -> float:
    """max |a - b| over max(floor, max |b|) of each instance (dim 0)."""
    if a.numel() == 0:
        return 0.0
    return float(_gap(a, b, _per_instance_scale(b, floor)).max())


def relative(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| / |b| elementwise (|b| floored at the smallest normal)."""
    if a.numel() == 0:
        return 0.0
    scale = torch.clamp(b.double().cpu().abs().nan_to_num(1.0),
                        min=torch.finfo(torch.float64).tiny)
    return float(_gap(a, b, scale).max())


def judge(readings: dict, limits: dict):
    """(correct, failed names): every number at or under its limit."""
    failed = [k for k, v in readings.items()
              if not (v <= limits[k]["limit"])]
    return not failed, failed


def lines(readings: dict, limits: dict) -> list:
    """One line per number, with its limit: ``check <name> <value> limit
    <limit>``."""
    return [f"check {k} {v!r} limit {limits.get(k, {}).get('limit')!r}"
            for k, v in readings.items()]
