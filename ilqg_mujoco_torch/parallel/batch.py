"""Batch/shard layer: the port of ``ilqg_mujoco_tpu/parallel/batch.py``.

Every function of the port already takes a leading batch dim of
independent instances, so a batched solve or MPC frame is a plain call.
Over several cards the batch is split the way the JAX package's
``P("data")`` sharding splits it: one process per card (a rank, see
``parallel/distributed.py``), each solving a contiguous block of the global
batch with the same batched code.  Instances are independent, so the only
collectives are metric reductions and the final gather.  A :class:`Mesh`
is one rank's view of that one ``data`` axis.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from .. import ilqr, mpc
from ..models.envs import Env
from ..physics.model import State, make_state, resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of the ``data`` axis: its rank, the number of
    ranks, and the device that holds its block."""
    rank: int
    world: int
    device: torch.device

    def block(self, batch: int) -> slice:
        """The rows [r B/W, (r+1) B/W) of a global batch of ``batch``
        instances that this rank holds; raises unless W divides B."""
        if batch % self.world:
            raise ValueError(f"a batch of {batch} does not split evenly over "
                             f"{self.world} ranks")
        n = batch // self.world
        return slice(self.rank * n, (self.rank + 1) * n)


def make_mesh(n_devices: int = None, device=None) -> Mesh:
    """This process's view of the ``data`` axis: its rank and the world
    size of the process group (rank 0 of 1 without one).  ``n_devices``,
    where given, must be that world size.  ``device`` defaults to this
    process's current card (``distributed.initialize`` sets it); the CPU
    runs only when asked for by name."""
    if dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
    else:
        rank, world = 0, 1
    if n_devices is not None and n_devices != world:
        raise ValueError(f"a mesh of {n_devices} devices asked for in a "
                         f"process group of {world}")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return Mesh(rank, world, dev)


def tree_map(fn, tree):
    """``fn`` applied to every tensor of a State, an ILQRState or another
    NamedTuple, a tuple, list or dict of them, or a tensor."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, State):
        return tree.map(fn)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, x) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, x) for x in tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    raise TypeError(f"cannot map over {type(tree).__name__}")


def shard_batch(tree, mesh: Mesh):
    """This rank's contiguous block of every leaf's leading (batch) dim,
    on the rank's device: the rows ``P("data")`` would place there."""
    def take(x):
        return x[mesh.block(x.shape[0])].to(mesh.device)
    return tree_map(take, tree)


def batch_states(env: Env, batch: int, qpos_noise: float = 0.0,
                 noise=None, generator: torch.Generator = None,
                 device=None, dtype=torch.float64) -> State:
    """A batch of initial states at qpos0, perturbed by
    ``qpos_noise * noise`` for diversity.  ``noise`` is a (batch, nq) array
    of standard normal draws (numpy or tensor); without it the draws come
    from ``generator`` on the CPU, so a seed gives the same batch on every
    device."""
    sb = make_state(env.model, batch, dtype, device)
    if qpos_noise > 0.0:
        if noise is None:
            noise = torch.randn((batch, env.model.nq), generator=generator,
                                dtype=torch.float64)
        noise = torch.as_tensor(noise, dtype=dtype).to(sb.qpos.device)
        sb = sb.replace(qpos=sb.qpos + qpos_noise * noise)
    return sb


def _on_mesh(fn, mesh: Mesh):
    """``fn`` refusing inputs that do not lie on the rank's device."""
    if mesh is None:
        return fn

    def sharded(states: State, sols: ilqr.ILQRState):
        if states.qpos.device != mesh.device:
            raise ValueError(f"rank {mesh.rank} holds its block on "
                             f"{mesh.device}, got states on "
                             f"{states.qpos.device}")
        return fn(states, sols)
    return sharded


def make_batched_solve(env: Env, mesh: Mesh = None):
    """(states, sols) -> (sols', cost traces (B, iterations)): one iLQR
    solve per instance.  With a mesh, the rank's block of the batch, on the
    rank's device."""
    m, cfg = env.model, env.ilqr

    def solve(states: State, sols: ilqr.ILQRState):
        return ilqr.solve(m, env.cost_fn, states, sols, cfg)
    return _on_mesh(solve, mesh)


def make_batched_mpc_step(env: Env, mesh: Mesh = None):
    """One MPC frame over a batch: re-solve + apply first control + physics
    step for every instance in lockstep.  (states, sols) -> (states', sols',
    step costs (B,)).  With a mesh, the rank's block of the batch."""
    def step(states: State, sols: ilqr.ILQRState):
        s2, sol2, (_, _, c) = mpc.mpc_step(env, states, sols)
        return s2, sol2, c
    return _on_mesh(step, mesh)


def init_batched(env: Env, batch: int, qpos_noise: float = 0.01, noise=None,
                 generator: torch.Generator = None, device=None,
                 dtype=torch.float64, mesh: Mesh = None):
    """Batched (states, solver states): each instance rolls out its own
    initial trajectory.  With a mesh, ``batch`` is the global batch: the
    noise of all of it is drawn (or ``noise`` read) as without one, and
    the rank keeps its block on its device, so rank r holds rows of the
    one-process batch whatever the number of ranks."""
    if mesh is None:
        sb = batch_states(env, batch, qpos_noise, noise, generator, device,
                          dtype)
    elif device is not None:
        raise ValueError("with a mesh the block goes to the mesh's device; "
                         "pass no device")
    else:
        # the whole batch's states on the CPU (the same additions and
        # products as on a card), then this rank's rows
        sb = shard_batch(batch_states(env, batch, qpos_noise, noise,
                                      generator, "cpu", dtype), mesh)
    return sb, ilqr.init_solver(env.model, sb, env.ilqr)
