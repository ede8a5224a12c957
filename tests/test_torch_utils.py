"""The port's auxiliary layers against the JAX package: checkpoint/resume
(the port's own round trip, and a checkpoint written by the JAX package
loading in the port), the frame helpers, the profiling utilities, and the
four public physics functions no other port module calls
(``constraint.make_efc``, ``smooth.body_velocities``,
``smooth.smooth_dynamics``, ``smooth.point_jacobian``).  The JAX package
runs eagerly, as its own tests run it."""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ilqg_mujoco_torch import ilqr, mpc
from ilqg_mujoco_torch.models import envs
from ilqg_mujoco_torch.parallel import batch
from ilqg_mujoco_torch.physics import collision, constraint, smooth
from ilqg_mujoco_torch.physics import forward as fwd
from ilqg_mujoco_torch.physics.model import make_state
from ilqg_mujoco_torch.utils import checkpoint, frames, profiling
from ilqg_mujoco_tpu import mpc as jmpc
from ilqg_mujoco_tpu.models import envs as jenvs
from ilqg_mujoco_tpu.physics import collision as jcollision
from ilqg_mujoco_tpu.physics import constraint as jconstraint
from ilqg_mujoco_tpu.physics import smooth as jsmooth
from ilqg_mujoco_tpu.utils import checkpoint as jcheckpoint

# the port against the JAX package in float64: the same operations up to
# summation order, rtol 1e-12 (entries that cancel to near zero within
# 1e-12 of the array's largest, as tests/test_torch_collision.py holds rows)
RTOL = 1e-12


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    """The JAX package's pendulum start (warm-in and initial rollout),
    written by its own checkpoint.save, as tests/test_utils.py does."""
    s0, sol0 = jmpc.init(jenvs.pendulum())
    path = tmp_path_factory.mktemp("jax") / "ck.npz"
    jcheckpoint.save(path, s0, sol0, extra={"frames": 7})
    return path


def test_checkpoint_roundtrip(tmp_path):
    """save -> load is bitwise at B=2, and the solve from the loaded state
    gives the same trace bit for bit."""
    env = envs.pendulum()
    env = dataclasses.replace(env, ilqr=dataclasses.replace(
        env.ilqr, horizon=8, iterations=2))
    s0, sol0 = batch.init_batched(env, 2, generator=torch.Generator()
                                  .manual_seed(0), device="cpu")
    p = tmp_path / "ck.npz"
    checkpoint.save(p, s0, sol0, extra={"frames": 7})
    s1, sol1, extra = checkpoint.load(p, device="cpu")
    assert int(extra["frames"]) == 7
    for name, a, b in [("env", s0, s1), ("traj", sol0.traj, sol1.traj)]:
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            assert x.dtype == y.dtype and torch.equal(x, y), (name, f.name)
    for f in ("K", "k", "mu"):
        assert torch.equal(getattr(sol0, f), getattr(sol1, f)), f
    _, tr_a = ilqr.solve(env.model, env.cost_fn, s0, sol0, env.ilqr)
    _, tr_b = ilqr.solve(env.model, env.cost_fn, s1, sol1, env.ilqr)
    assert torch.equal(tr_a, tr_b)
    # dtype=None keeps the file's dtype; a dtype converts
    s32, sol32, _ = checkpoint.load(p, device="cpu", dtype=torch.float32)
    assert s32.qpos.dtype == sol32.K.dtype == torch.float32


def test_jax_checkpoint_loads_in_port(jax_checkpoint):
    """Every array equals the JAX package's with a leading batch dim of
    1."""
    s, sol, extra = checkpoint.load(jax_checkpoint, device="cpu")
    z = np.load(jax_checkpoint)
    assert int(extra["frames"]) == 7
    got = {f"env/{f}": getattr(s, f) for f in ("time", "qpos", "qvel",
                                               "qacc", "qacc_warmstart",
                                               "qfrc_applied",
                                               "xfrc_applied", "ctrl")}
    got.update({f"sol/traj/{k[4:]}": getattr(sol.traj, k[4:])
                for k in got})
    got.update({"sol/K": sol.K, "sol/k": sol.k, "sol/mu": sol.mu})
    assert sorted(got) == sorted(k for k in z.files
                                 if not k.startswith("extra/"))
    for k, v in got.items():
        assert v.dtype == torch.float64, k
        np.testing.assert_array_equal(v.numpy(), z[k][None], err_msg=k)


def test_port_init_matches_jax_checkpoint(jax_checkpoint):
    s, sol, _ = checkpoint.load(jax_checkpoint, device="cpu")
    s0, sol0 = mpc.init(envs.pendulum(), device="cpu")
    pairs = [(f"env {f.name}", getattr(s0, f.name), getattr(s, f.name))
             for f in dataclasses.fields(s)]
    pairs += [(f"traj {f.name}", getattr(sol0.traj, f.name),
               getattr(sol.traj, f.name)) for f in dataclasses.fields(s)]
    pairs += [(f, getattr(sol0, f), getattr(sol, f)) for f in ("K", "k",
                                                                "mu")]
    for name, got, want in pairs:
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL,
                                   atol=0, err_msg=name)


def test_forward_frame_cartpole():
    """dt=0.02: one step per 60 fps frame."""
    m = envs.pendulum().model
    s = make_state(m, 2, device="cpu")
    assert frames.steps_per_frame(m) == 1
    s2 = frames.forward_frame(m, s)
    one = frames.forward_step(m, s)
    for f in dataclasses.fields(s2):
        assert torch.equal(getattr(s2, f.name), getattr(one, f.name))
    assert float(s2.time[0]) == pytest.approx(0.02, abs=1e-15)


def test_forward_frame_hopper():
    """dt=0.002: round(1/60/0.002) = 8 steps per frame, bit for bit the
    same as 8 forward.step calls."""
    env = envs.hopper()
    m = env.model
    s = batch.batch_states(env, 2, 0.01, generator=torch.Generator()
                           .manual_seed(0), device="cpu")
    assert frames.steps_per_frame(m) == 8
    got = frames.forward_frame(m, s)
    want = s
    for _ in range(8):
        want = fwd.step(m, want)
    for f in dataclasses.fields(got):
        assert torch.equal(getattr(got, f.name), getattr(want, f.name))
    assert torch.allclose(got.time, torch.full((2,), 8 * 0.002,
                                               dtype=torch.float64),
                          rtol=0, atol=1e-12)


def test_timer_phases():
    t = profiling.Timer("cpu")
    for _ in range(2):
        with t.phase("a") as box:
            torch.ones(4).sum()
    assert box["seconds"] > 0.0
    assert t.counts["a"] == 2 and t.times["a"] >= box["seconds"]
    assert "a" in t.report()
    assert json.loads(t.as_json())["a"]["count"] == 2
    assert profiling.throughput(10, 2.0, "frames") == "5 frames/s"


def test_trace_writes_chrome_trace(tmp_path):
    with profiling.trace(tmp_path / "tr"):
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    out = tmp_path / "tr" / "trace.json"
    assert out.exists() and json.loads(out.read_text())["traceEvents"]


def test_physics_functions_match_jax():
    """make_efc, body_velocities, smooth_dynamics and point_jacobian on the
    hopper at a perturbed state, against the JAX package's."""
    m = envs.hopper().model
    jm = jenvs.hopper().model
    rng = np.random.default_rng(0)
    qpos = np.asarray(m.qpos0) + 0.05 * rng.standard_normal(m.nq)
    qvel = rng.standard_normal(m.nv)
    ctrl = rng.standard_normal(m.nu)
    qfrc = 0.1 * rng.standard_normal(m.nv)
    xfrc = 0.1 * rng.standard_normal((m.nbody, 6))
    body = 3

    jkin = jsmooth.kinematics(jm, jnp.asarray(qpos))
    jcon = jcollision.collide(jm, jkin.geom_xpos, jkin.geom_xmat)
    jefc = jconstraint.make_efc(jm, jkin, jnp.asarray(qpos),
                                jnp.asarray(qvel), jcon)
    jsd = jsmooth.smooth_dynamics(jm, *map(jnp.asarray, (qpos, qvel, ctrl,
                                                         qfrc, xfrc)))
    want = {"efc J": jefc.J, "efc D": jefc.D, "efc aref": jefc.aref,
            "efc pos": jefc.pos,
            "body_velocities": jsmooth.body_velocities(jm, jkin,
                                                       jnp.asarray(qvel)),
            "M": jsd[0].M, "qfrc_smooth": jsd[1], "qacc_smooth": jsd[2],
            "Mfac": jsd[3],
            "point_jacobian": jsmooth.point_jacobian(jm, jkin,
                                                     jkin.xipos[body], body)}

    t = lambda a: torch.tensor(a, dtype=torch.float64)[None]
    kin = smooth.kinematics(m, t(qpos))
    con = collision.collide(m, kin.geom_xpos, kin.geom_xmat)
    efc = constraint.make_efc(m, kin, t(qpos), t(qvel), con)
    sd = smooth.smooth_dynamics(m, *map(t, (qpos, qvel, ctrl, qfrc, xfrc)))
    got = {"efc J": efc.J, "efc D": efc.D, "efc aref": efc.aref,
           "efc pos": efc.pos,
           "body_velocities": smooth.body_velocities(m, kin, t(qvel)),
           "M": sd[0].M, "qfrc_smooth": sd[1], "qacc_smooth": sd[2],
           "Mfac": sd[3],
           "point_jacobian": smooth.point_jacobian(m, kin,
                                                   kin.xipos[:, body],
                                                   body)}
    assert bool((efc.D > 0).any())          # some rows are active
    # a body index per instance gives the same rows as the int
    assert torch.equal(smooth.point_jacobian(m, kin, kin.xipos[:, body],
                                             torch.tensor([body])),
                       got["point_jacobian"])
    for k in want:
        w = np.asarray(want[k])
        np.testing.assert_allclose(got[k][0].numpy(), w, rtol=RTOL,
                                   atol=RTOL * np.abs(w).max(), err_msg=k)
