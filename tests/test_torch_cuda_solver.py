"""PyTorch port, the constraint solver's loop on the card: each CG iteration
is the replay of a CUDA graph captured once per shape over static buffers.
It must give what the eager loop on the CPU gives, in both solver modes,
also on a second call with other values (the buffers are reloaded, not
captured again).  The inputs are hopper states in contact.  Tolerance
rtol 1e-9 / atol 1e-10 on qacc, and the same iteration count per instance:
the same float64 operations on two devices.  Skips without a card; on the
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
