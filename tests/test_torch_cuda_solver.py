"""PyTorch port, the constraint solver's loop on the card: each CG iteration
is the replay of a CUDA graph captured once per shape over static buffers.
It must give what the eager loop on the CPU gives, in both solver modes,
also on a second call with other values (the buffers are reloaded, not
captured again).  The inputs are hopper states in contact.  Tolerance
rtol 1e-9 / atol 1e-10 on qacc, and the same iteration count per instance:
the same float64 operations on two devices.  The cache of captured steps
is a bounded LRU: a shape evicted and captured again gives the same bits.
With two cards, a solve on the second while the first is current gives
the first one's bits (its graph is captured on its own card).  Skips
without a card; on the
card, where JAX may be missing,

    python -m pytest tests/test_torch_cuda_solver.py -m cuda --noconftest

runs it alone."""

import pytest
import torch

from ilqg_mujoco_torch.models import envs
from ilqg_mujoco_torch.ops import linalg
from ilqg_mujoco_torch.parallel import batch
from ilqg_mujoco_torch.physics import forward as fwd
from ilqg_mujoco_torch.physics import solver


def _problems(seed):
    """The constraint problems of 64 hopper instances 100 steps after a
    noisy start (on the floor), as CPU tensors."""
    env = envs.make("hopper")
    gen = torch.Generator().manual_seed(seed)
    s = batch.batch_states(env, 64, 0.01, generator=gen, device="cpu")
    for _ in range(100):
        s = fwd.step(env.model, s)
    _, aux = fwd.forward_full(env.model, s)
    return (aux.kin.M, linalg.cholesky(aux.kin.M), aux.qacc_smooth,
            aux.efc.J, aux.efc.D, aux.efc.aref, s.qacc_warmstart)


@pytest.mark.cuda
@pytest.mark.parametrize("tolerance", [0.0, 1e-8],
                         ids=["pinned", "early_exit"])
def test_graphed_cg_matches_cpu(tolerance):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    iterations = 30 if tolerance == 0.0 else 100
    for seed in (0, 1):
        args = _problems(seed)
        x, it = solver._solve_cg(*args, iterations, tolerance, 16)
        xg, itg = solver._solve_cg(*(a.cuda() for a in args), iterations,
                                   tolerance, 16)
        assert torch.equal(itg.cpu(), it)
        torch.testing.assert_close(xg.cpu(), x, rtol=1e-9, atol=1e-10)


@pytest.mark.cuda
def test_graph_cache_is_bounded_and_eviction_keeps_bits(monkeypatch):
    """Three batch sizes through a cache bounded at two graphs: the cache
    never holds more than two, the first shape is evicted and captured
    again, and its second solve gives the first one's bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    solver.clear_graphs()
    monkeypatch.setattr(solver._GRAPHS, "size", 2)
    args = [a.cuda() for a in _problems(0)]
    results = []
    for n in (64, 32, 16, 64):
        results.append(solver._solve_cg(*(a[:n] for a in args), 100, 1e-8,
                                        16))
        assert len(solver._GRAPHS.steps) <= 2
    assert len(solver._GRAPHS.keys) == 3 and solver._GRAPHS.captures == 4
    (x0, it0), (x3, it3) = results[0], results[3]
    assert torch.equal(x0, x3) and torch.equal(it0, it3)
    solver.clear_graphs()
    assert not solver._GRAPHS.steps


@pytest.mark.cuda
def test_graphed_cg_on_a_second_card():
    """A solve on cuda:1 while cuda:0 is current captures and replays its
    graph on cuda:1: the bits of the same solve on cuda:0."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs")
    args = _problems(0)
    with torch.cuda.device(0):
        x0, it0 = solver._solve_cg(*(a.to("cuda:0") for a in args), 30, 0.0,
                                   16)
        x1, it1 = solver._solve_cg(*(a.to("cuda:1") for a in args), 30, 0.0,
                                   16)
    assert x1.device == torch.device("cuda:1")
    assert torch.equal(it1.cpu(), it0.cpu())
    assert torch.equal(x1.cpu(), x0.cpu())
    solver.clear_graphs()
