"""The seeded inputs of a run.

The program's batch layer (``parallel/batch.init_batched``) starts every
instance at the model's qpos0 plus ``qpos_noise`` times standard normal
draws.  Here the draws come from one ``torch.Generator`` on the run's
device, seeded with the run's ``--seed``, in one call: a pool of batches,
one for each solve the window may run, and one more for the warm-up.  The
same draws go to the program (as ``init_batched``'s ``noise``) and to the
reference, which adds them to its own qpos0.
"""

from __future__ import annotations

import torch

SEED_MOD = 2 ** 63


def generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded with ``seed`` (any whole number)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % SEED_MOD)
    return g


def noise_pool(seed: int, batches: int, batch: int, nq: int, device,
               dtype=torch.float64) -> torch.Tensor:
    """(batches, batch, nq) standard normal draws from ``seed``."""
    return torch.randn((batches, batch, nq), generator=generator(seed, device),
                       device=device, dtype=dtype)


def instances(seed: int, solve: int, batch: int, k: int) -> list:
    """The ``k`` distinct instances of solve ``solve`` whose answers the
    window keeps for the check, drawn from ``seed`` on the CPU, in batch
    order (all of them where ``k`` is the batch)."""
    g = torch.Generator().manual_seed((int(seed) * 1000003 + solve) % SEED_MOD)
    return sorted(torch.randperm(batch, generator=g)[:min(k, batch)].tolist())


def choose(seed: int, items: list, most: int) -> list:
    """At most ``most`` of ``items`` (the window's solves), drawn from
    ``seed`` on the CPU, in their order."""
    if len(items) <= most:
        return list(items)
    g = torch.Generator().manual_seed((int(seed) + 7) % SEED_MOD)
    keep = sorted(torch.randperm(len(items), generator=g)[:most].tolist())
    return [items[j] for j in keep]
