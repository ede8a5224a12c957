"""Carry states across packages and devices as numpy arrays.

A State or ILQRState becomes a dict of numpy arrays and back; this is how a
test hands the JAX package's states to the port without the port ever
seeing JAX.  Arrays are batch-leading, as everywhere in the port.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ilqr import ILQRState
from ..physics.model import State, resolve_device

STATE_FIELDS = tuple(f.name for f in dataclasses.fields(State))


def state_from_numpy(d: dict, device=None, dtype=torch.float64) -> State:
    """State from a dict with every State field, batch dims leading."""
    dev = resolve_device(device)
    return State(**{f: torch.tensor(np.asarray(d[f]), dtype=dtype,
                                       device=dev) for f in STATE_FIELDS})


def solver_state_from_numpy(traj: dict, K, k, mu, device=None,
                            dtype=torch.float64) -> ILQRState:
    """ILQRState from a trajectory dict (B, N+1, ...) and the gains."""
    dev = resolve_device(device)
    t = lambda a: torch.tensor(np.asarray(a), dtype=dtype, device=dev)
    return ILQRState(traj=state_from_numpy(traj, dev, dtype), K=t(K), k=t(k),
                     mu=t(mu))


def to_numpy(x) -> dict:
    """State -> {field: array}; ILQRState -> {"traj": {...}, "K", "k",
    "mu"}."""
    if isinstance(x, ILQRState):
        return {"traj": to_numpy(x.traj), "K": x.K.cpu().numpy(),
                "k": x.k.cpu().numpy(), "mu": x.mu.cpu().numpy()}
    if isinstance(x, State):
        return {f: getattr(x, f).cpu().numpy() for f in STATE_FIELDS}
    raise TypeError(f"cannot convert {type(x).__name__}")
