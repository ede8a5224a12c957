"""PyTorch port, the data-parallel layer on the CPU: the counterparts of
tests/test_parallel.py.  ``shard_batch`` keeps the rows ``P("data")``
places on a rank, and a batch that does not divide raises.  Two ``gloo``
ranks (``parallel/distributed.launch``, one torch thread each) run the
cart-pole compat+fd solve and 2 MPC frames at ``tools/distributed_check.py``'s
cut (B=8, N=10, 3 iterations, 0.02 x numpy's ``RandomState(0)`` draws) over
``tools/distributed_check``'s rank function: the gathered batch must equal
the port's one-process run bit for bit (the blocks run the same operations
as the whole batch on the CPU), and the JAX package's
``make_batched_solve(env, make_mesh())`` on conftest's 8-device virtual mesh
at test_distributed.py's rtol 1e-5 (one module-scoped JAX compile).
``global_mean`` of arange(8) over 2 ranks is 3.5."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ilqg_mujoco_tpu import ilqr as jilqr
from ilqg_mujoco_tpu.models import envs as jenvs
from ilqg_mujoco_tpu.parallel import batch as jbatch

from ilqg_mujoco_torch import ilqr
from ilqg_mujoco_torch.models import envs
from ilqg_mujoco_torch.parallel import batch, distributed
from ilqg_mujoco_torch.tools import distributed_check as dc

CFG = dc.Config(batch=8, horizon=10, iterations=3, frames=2,
                qpos_noise=0.02, numpy_noise=True)
TIMEOUT = 300          # seconds for the ranks of one launch to end


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread here and in every rank: the suite runs several
    workers on a few cores, and tensors this small gain nothing from
    more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    mp = pytest.MonkeyPatch()
    mp.setenv("OMP_NUM_THREADS", "1")
    yield
    mp.undo()
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def two_ranks():
    return distributed.launch(dc.rank_check, 2, CFG, device="cpu",
                              timeout=TIMEOUT)


@pytest.fixture(scope="module")
def one_process():
    return dc.rank_check(batch.make_mesh(1, "cpu"), CFG)


@pytest.fixture(scope="module")
def jax_sharded():
    """tools/distributed_check.py's solve in one process on the 8-device
    mesh: the states at qpos_noise 0 (``batch_states``, which
    ``init_batched`` calls), the noise added, the solver initialised."""
    env = jenvs.pendulum()
    env = dataclasses.replace(env, ilqr=dataclasses.replace(
        env.ilqr, horizon=CFG.horizon, iterations=CFG.iterations))
    noise = 0.02 * np.random.RandomState(0).randn(CFG.batch, env.model.nq)
    sb = jbatch.batch_states(env, CFG.batch, qpos_noise=0.0)
    sb = sb.replace(qpos=sb.qpos + jnp.asarray(noise))
    sols = jax.vmap(lambda s: jilqr.init_solver(env.model, s, env.ilqr))(sb)
    mesh = jbatch.make_mesh()
    sols2, traces = jbatch.make_batched_solve(env, mesh)(
        jbatch.shard_batch(sb, mesh), jbatch.shard_batch(sols, mesh))
    return np.asarray(traces), np.asarray(sols2.traj.qpos)


def test_shard_batch_keeps_the_data_axis_rows():
    env = dataclasses.replace(envs.pendulum(), ilqr=ilqr.ILQRConfig(
        horizon=3, iterations=1))
    gen = torch.Generator().manual_seed(0)
    states, sols = batch.init_batched(env, 8, generator=gen, device="cpu")
    blocks = []
    for r in range(2):
        mesh = batch.Mesh(r, 2, torch.device("cpu"))
        s, so = batch.shard_batch((states, sols), mesh)
        assert s.qpos.shape == (4, env.model.nq)
        assert torch.equal(s.qpos, states.qpos[4 * r:4 * r + 4])
        assert torch.equal(so.K, sols.K[4 * r:4 * r + 4])
        # a rank's init_batched holds the same rows of the same start
        gen = torch.Generator().manual_seed(0)
        s2, so2 = batch.init_batched(env, 8, generator=gen, mesh=mesh)
        for a, b in ((s2.qpos, s.qpos), (so2.traj.qpos, so.traj.qpos),
                     (so2.mu, so.mu)):
            assert torch.equal(a, b)
        blocks.append(s)
    assert torch.equal(torch.cat([b.qpos for b in blocks]), states.qpos)
    one = batch.make_mesh(1, "cpu")
    assert (one.rank, one.world) == (0, 1)
    assert distributed.gather_batch(states, one) is states


@pytest.mark.parametrize("batch_size, world", [(8, 3), (9, 2)])
def test_batch_that_does_not_divide_raises(batch_size, world):
    mesh = batch.Mesh(0, world, torch.device("cpu"))
    with pytest.raises(ValueError, match="does not split evenly"):
        batch.shard_batch(torch.zeros(batch_size, 2), mesh)
    with pytest.raises(ValueError, match="does not split evenly"):
        batch.init_batched(envs.pendulum(), batch_size, mesh=mesh)


def test_two_ranks_equal_one_process(two_ranks, one_process):
    errs = dc.compare(two_ranks, one_process)          # bit for bit
    assert set(errs) >= {"trace", "qpos", "ctrl", "K", "k"}
    records = [r["record"] for r in two_ranks]
    assert [r["block"] for r in records] == [[0, 4], [4, 8]]
    assert {(r["world"], r["device"]) for r in records} == {(2, "cpu")}
    assert all(r["launches"] == 0 for r in records)   # the plain version
    assert one_process["arrays"]["trace"].shape == (CFG.batch,
                                                    CFG.iterations)


def test_two_mpc_frames_over_two_ranks_equal_one_process(two_ranks,
                                                         one_process):
    got, want = two_ranks[0]["arrays"], one_process["arrays"]
    assert got["frame_costs"].shape == (CFG.batch, CFG.frames)
    for name in ("frame_costs", "frame_qpos"):
        assert torch.equal(got[name], want[name]), name
    assert two_ranks[1]["arrays"] is None               # rank 0 returns it


def test_two_ranks_equal_jax_sharded_solve(two_ranks, jax_sharded):
    traces, qpos = jax_sharded
    got = two_ranks[0]["arrays"]
    np.testing.assert_allclose(got["trace"].numpy(), traces, rtol=1e-5)
    np.testing.assert_allclose(got["qpos"].numpy(), qpos, rtol=1e-5,
                               atol=1e-8)


def test_global_mean_over_two_ranks():
    means = distributed.launch(dc.rank_mean, 2, torch.arange(8.0),
                               device="cpu", timeout=TIMEOUT)
    assert means == [3.5, 3.5]
