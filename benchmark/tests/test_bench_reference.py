"""The frozen reference against the program at a CPU size: the same
physics step, the same solves."""

import dataclasses

import torch

from benchmark import harness, program
from benchmark.reference import drive
from benchmark.reference import forward as rfwd
from benchmark.yardstick import inputs


def _both(cell, horizon, iterations, batch):
    spec = harness.load_spec(cell)
    spec.conf.update(horizon=horizon, iterations=iterations)
    env = program.program_env(spec.conf)
    ref = drive.build(spec.conf, device="cpu")
    noise = inputs.noise_pool(11, 1, batch, spec.conf["nq"], "cpu")[0]
    return spec, env, ref, noise


def _program_solve(env, noise, qn):
    from ilqg_mujoco_torch.parallel import batch as pbatch
    states, sols = pbatch.init_batched(env, noise.shape[0], qn, noise=noise,
                                       device="cpu")
    sols, trace = pbatch.make_batched_solve(env)(states, sols)
    return sols, trace


def test_cartpole_solve_matches_the_program():
    spec, env, ref, noise = _both("cartpole_solve_b16384", 8, 3, 3)
    sols, trace = _program_solve(env, noise, 0.01)
    r = drive.solve(ref, noise, 0.01)
    assert torch.allclose(trace, r["cost"], rtol=1e-10, atol=0)
    assert torch.allclose(sols.traj.qpos, r["qpos"], rtol=0, atol=1e-11)
    assert torch.allclose(sols.K, r["K"], rtol=1e-8,
                          atol=1e-9 * float(r["K"].abs().max()))


def test_humanoid_step_and_solve_match_the_program():
    spec, env, ref, noise = _both("humanoid_solve_b16", 3, 1, 1)
    from ilqg_mujoco_torch.physics import forward as pfwd
    from ilqg_mujoco_torch.physics.model import make_state
    s = make_state(env.model, 1, device="cpu")
    s = s.replace(qpos=s.qpos + 0.01 * noise)
    rs = drive.initial_states(ref, noise, 0.01)
    for _ in range(3):
        s, rs = pfwd.step(env.model, s), rfwd.step(ref.model, rs)
    assert torch.allclose(s.qpos, rs.qpos, rtol=0, atol=1e-12)
    assert torch.allclose(s.qvel, rs.qvel, rtol=0, atol=1e-10)
    sols, trace = _program_solve(env, noise, 0.01)
    r = drive.solve(ref, noise, 0.01)
    assert torch.allclose(trace, r["cost"], rtol=1e-9, atol=0)
    assert torch.equal(sols.mu, r["mu"])
    assert torch.allclose(sols.K, r["K"], rtol=1e-6,
                          atol=1e-7 * float(r["K"].abs().max()))


def test_reference_model_matches_the_configuration():
    for cell in ("cartpole_solve_b16384", "humanoid_solve_b16"):
        spec = harness.load_spec(cell)
        m = drive.build(spec.conf).model
        assert (m.nq, m.nv, m.nu) == (spec.conf["nq"], spec.conf["nv"],
                                      spec.conf["nu"])
        env = program.program_env(spec.conf)
        assert env.ilqr.horizon == spec.conf["horizon"]
        from benchmark.reference import collision, constraint, smooth
        from benchmark.reference.model import make_state
        s = make_state(m, 1, device="cpu")
        kin = smooth.kinematics(m, s.qpos)
        con = collision.collide(m, kin.geom_xpos, kin.geom_xmat)
        efc = constraint.make_efc(m, kin, s.qpos, s.qvel, con)
        assert efc.J.shape[-2] == spec.conf["nefc"]
        assert dataclasses.asdict(env.ilqr.lin)["chunk_knots"] is None
