"""Checkpoint and resume of (env state, solver state): the port of
``ilqg_mujoco_tpu/utils/checkpoint.py``'s npz backend.

The file layout is the JAX package's, key for key: ``env/<field>`` and
``sol/traj/<field>`` for every State field, ``sol/K``, ``sol/k``,
``sol/mu`` and ``extra/<name>``.  Arrays are batch-leading, as everywhere
in the port.  A file whose ``sol/mu`` is a scalar holds one instance
written by the JAX package; ``load`` gives each of its arrays a leading
batch dim of 1, so such a run resumes in the port.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ilqr import ILQRState
from ..physics.model import State, resolve_device
from . import convert


def save(path, env_state: State, solver_state: ILQRState,
         extra: dict = None) -> None:
    """Write (env State, ILQRState) and the ``extra`` arrays to an npz."""
    sol = convert.to_numpy(solver_state)
    payload = {f"env/{f}": a for f, a in convert.to_numpy(env_state).items()}
    payload.update({f"sol/traj/{f}": a for f, a in sol["traj"].items()})
    payload.update({f"sol/{n}": sol[n] for n in ("K", "k", "mu")})
    payload.update({f"extra/{n}": np.asarray(v)
                    for n, v in (extra or {}).items()})
    np.savez(path, **payload)


def load(path, device=None, dtype=None):
    """(env State, ILQRState, extras) from an npz, on ``device`` (the card
    unless the CPU is asked for) in ``dtype`` (``None``: the file's)."""
    dev = resolve_device(device)
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    extra = {k[len("extra/"):]: v for k, v in arrays.items()
             if k.startswith("extra/")}
    if arrays["sol/mu"].ndim == 0:          # one instance, JAX layout
        arrays = {k: v[None] for k, v in arrays.items()}
    if dtype is None:
        dtype = torch.from_numpy(arrays["env/qpos"][:0]).dtype
    grab = lambda prefix: {f: arrays[prefix + f] for f in convert.STATE_FIELDS}
    env_state = convert.state_from_numpy(grab("env/"), dev, dtype)
    sol = convert.solver_state_from_numpy(
        grab("sol/traj/"), arrays["sol/K"], arrays["sol/k"], arrays["sol/mu"],
        dev, dtype)
    return env_state, sol, extra
