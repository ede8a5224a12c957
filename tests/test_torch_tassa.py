"""PyTorch port, the tassa iLQG path on the cart-pole against the JAX
package (float64, CPU): cost quadratics, the sequential backward pass
(plain, value-scaled, control-limited), the associative-scan backward
pass, and batched solves instance by instance.  boxQP and the
control-limited solve are in tests/test_torch_boxqp.py.

Inputs come from a seed or from fixed states and reach both packages as
numpy arrays.  Each test states its tolerance.  Solves use the ``ad``
engine, whose exact derivatives keep the two packages within ~1e-13 of
each other over a few iterations (no FD noise to amplify)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ilqg_mujoco_tpu import ilqr as jilqr
from ilqg_mujoco_tpu.models import envs as jenvs
from ilqg_mujoco_tpu.ops.linearize import LinOut as JLinOut
from ilqg_mujoco_tpu.physics.model import State as JState
from ilqg_mujoco_torch import ilqr, mpc
from ilqg_mujoco_torch.models import envs
from ilqg_mujoco_torch.ops.linearize import linearize_traj
from ilqg_mujoco_torch.parallel import batch
from ilqg_mujoco_torch.physics.model import make_state
from ilqg_mujoco_torch.utils.convert import to_numpy

UMAX = 0.35      # the tight ctrl box of tests/test_boxqp.py


def _tight(model, umax=UMAX):
    """The model with its actuator limited to |u| <= umax."""
    return dataclasses.replace(model,
                               actuator_ctrlrange=np.array([[-umax, umax]]),
                               actuator_ctrllimited=np.array([True]))


def _states(m, qpos):
    return make_state(m, len(qpos), device="cpu").replace(
        qpos=torch.tensor(qpos, dtype=torch.float64))


def _jtree(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


@pytest.fixture(scope="module")
def problem():
    """Two cart-pole trajectories (the second displaced towards the hinge
    limit) and their ad linearization, in both packages' forms."""
    env = envs.pendulum("tassa", "ad")
    m, cfg = env.model, env.ilqr
    s = _states(m, [[0.1, 0.4], [-0.5, 1.2]]).replace(
        ctrl=torch.tensor([[0.3], [-0.8]], dtype=torch.float64))
    traj = ilqr.init_solver(m, s, cfg).traj
    lin = linearize_traj(m, traj, env.cost_fn, cfg.lin)
    jtraj = JState(**_jtree(to_numpy(traj)))
    jlin = JLinOut(*(jnp.asarray(x.numpy()) for x in lin))
    return env, traj, lin, jtraj, jlin


def test_cost_quadratics_match_jax(problem):
    """Exact AD expansions of a quadratic cost: the same numbers to
    rounding (rtol 1e-12, atol 1e-12)."""
    env, traj, _, jtraj, _ = problem
    got = ilqr._cost_quadratics(env.cost_fn, env.model, traj)
    jenv = jenvs.pendulum("tassa", "ad")
    want = jax.jit(jax.vmap(lambda t: jilqr._cost_quadratics(
        jenv.cost_fn, jenv.model, t)))(jtraj)
    shapes = [(2, 21, 4), (2, 21, 1), (2, 21, 4, 4), (2, 21, 1, 1),
              (2, 21, 1, 4)]
    for name, g, w, shape in zip(("lx", "lu", "lxx", "luu", "lux"), got,
                                 want, shapes):
        assert g.shape == shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12,
                                   atol=1e-12, err_msg=name)


BACKWARD_CASES = {
    "plain": dict(),
    "value_scaling": dict(value_scaling=True),
    "control_limits": dict(control_limits=True),
    "control_limits_value_scaling": dict(control_limits=True,
                                         value_scaling=True),
}


@pytest.mark.parametrize("case", list(BACKWARD_CASES))
def test_backward_pass_tassa_matches_jax(problem, case):
    """The same linearization and per-instance mu through both packages'
    sequential backward pass.  The control-limited cases use the tight
    |u| <= 0.35 box so that boxQP clamps.  Tolerance rtol 1e-9 / atol 1e-11
    on the gains, rtol 1e-9 on dV: the same recursion in float64 in
    another summation order."""
    env, traj, lin, jtraj, jlin = problem
    flags = BACKWARD_CASES[case]
    cfg = dataclasses.replace(env.ilqr, **flags)
    m = _tight(env.model) if cfg.control_limits else env.model
    mu = np.array([1e-6, 3e-2])
    K, k, dV1, dV2, ok = ilqr.backward_pass_tassa(
        m, traj, lin, env.cost_fn, torch.tensor(mu), cfg)
    jenv = jenvs.pendulum("tassa", "ad")
    jm = _tight(jenv.model) if cfg.control_limits else jenv.model
    jcfg = dataclasses.replace(jenv.ilqr, **flags)
    want = jax.jit(jax.vmap(lambda t, li, u: jilqr.backward_pass_tassa(
        jm, t, li, jenv.cost_fn, u, jcfg)))(jtraj, jlin, jnp.asarray(mu))
    if cfg.control_limits:
        # the box binds somewhere: a clamped control has no feedback
        assert bool((K[:, :-1] == 0).all(-1).any())
    for name, g, w in (("K", K, want[0]), ("k", k, want[1])):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-9,
                                   atol=1e-11, err_msg=name)
    np.testing.assert_allclose(dV1.numpy(), np.asarray(want[2]), rtol=1e-9)
    np.testing.assert_allclose(dV2.numpy(), np.asarray(want[3]), rtol=1e-9)
    assert ok.tolist() == np.asarray(want[4]).tolist() == [True, True]


@pytest.fixture(scope="module")
def assoc_setup():
    """test_assoc_riccati.py's setup: horizon 25 from the warmed-in
    cart-pole, after one accepted iteration, with mu = 1e-9."""
    env = envs.pendulum("tassa", "ad")
    env = dataclasses.replace(env, ilqr=dataclasses.replace(env.ilqr,
                                                            horizon=25))
    s0, sol0 = mpc.init(env, device="cpu")
    sol, _ = ilqr.iterate_tassa(env.model, env.cost_fn, s0, sol0, env.ilqr)
    lin = linearize_traj(env.model, sol.traj, env.cost_fn, env.ilqr.lin)
    return env, sol, lin, torch.tensor([1e-9], dtype=torch.float64)


def test_assoc_backward_matches_sequential(assoc_setup):
    """The log-depth scan against the sequential pass: equal as mu -> 0,
    at test_assoc_riccati.py's rtol 1e-6 / atol 1e-8."""
    env, sol, lin, mu = assoc_setup
    seq = ilqr.backward_pass_tassa(env.model, sol.traj, lin, env.cost_fn,
                                   mu, env.ilqr)
    par = ilqr.backward_pass_assoc(env.model, sol.traj, lin, env.cost_fn,
                                   mu, env.ilqr)
    assert bool(seq[4].all()) and bool(par[4].all())
    for i, name in ((0, "K"), (1, "k")):
        np.testing.assert_allclose(par[i].numpy(), seq[i].numpy(), rtol=1e-6,
                                   atol=1e-8, err_msg=name)
    np.testing.assert_allclose(par[2].numpy(), seq[2].numpy(), rtol=1e-6)
    np.testing.assert_allclose(par[3].numpy(), seq[3].numpy(), rtol=1e-6)


def test_assoc_backward_matches_jax_assoc(assoc_setup):
    """The port's Hillis-Steele scan against lax.associative_scan on the
    same inputs.  The two combine the 26 elements in different trees, so
    the suffixes differ by rounding that the 25-step products amplify:
    rtol 1e-7 / atol 1e-9 on the gains, rtol 1e-7 on dV."""
    env, sol, lin, mu = assoc_setup
    got = ilqr.backward_pass_assoc(env.model, sol.traj, lin, env.cost_fn,
                                   mu, env.ilqr)
    jenv = jenvs.pendulum("tassa", "ad")
    jcfg = dataclasses.replace(jenv.ilqr, horizon=25)
    jtraj = JState(**{k: jnp.asarray(v[0])
                      for k, v in to_numpy(sol.traj).items()})
    jlin = JLinOut(*(jnp.asarray(x[0].numpy()) for x in lin))
    want = jax.jit(lambda t, li: jilqr.backward_pass_assoc(
        jenv.model, t, li, jenv.cost_fn, jnp.asarray(1e-9), jcfg))(jtraj,
                                                                  jlin)
    for i, name in ((0, "K"), (1, "k")):
        np.testing.assert_allclose(got[i][0].numpy(), np.asarray(want[i]),
                                   rtol=1e-7, atol=1e-9, err_msg=name)
    np.testing.assert_allclose(got[2].numpy(), [float(want[2])], rtol=1e-7)
    np.testing.assert_allclose(got[3].numpy(), [float(want[3])], rtol=1e-7)
    assert bool(got[4][0]) and bool(want[4])


def test_assoc_solve_descends_like_sequential():
    """Full solves with either backward pass follow the same accepted-cost
    path while mu stays small (rtol 1e-4, as test_assoc_riccati.py), and
    descend."""
    env = envs.pendulum("tassa", "ad")
    cfg_seq = dataclasses.replace(env.ilqr, horizon=40, iterations=6)
    cfg_par = dataclasses.replace(cfg_seq, backward="assoc")
    env = dataclasses.replace(env, ilqr=cfg_seq)
    s0, sol0 = mpc.init(env, device="cpu")
    _, tr_seq = ilqr.solve(env.model, env.cost_fn, s0, sol0, cfg_seq)
    _, tr_par = ilqr.solve(env.model, env.cost_fn, s0, sol0, cfg_par)
    tr_seq, tr_par = tr_seq[0].numpy(), tr_par[0].numpy()
    assert np.all(np.isfinite(tr_par))
    np.testing.assert_allclose(tr_par, tr_seq, rtol=1e-4)
    assert tr_par[-1] < 0.95 * tr_par[0]


def test_batched_tassa_solve_matches_jax():
    """A diverse B=3 batch, 3 iterations, through make_batched_solve of both
    packages, instance by instance: trace, trajectory, controls, K, k and
    mu.  Tolerance rtol 1e-9 / atol 1e-11 (atol 1e-10 on K): three
    iterations of exact-derivative solves in float64."""
    solve_matches_jax()


def solve_matches_jax(**flags):
    """The check of test_batched_tassa_solve_matches_jax under ILQRConfig
    ``flags``; with control_limits on the model gets the tight box, so
    the rollout clips."""
    env = envs.pendulum("tassa", "ad")
    env = dataclasses.replace(env, ilqr=dataclasses.replace(
        env.ilqr, iterations=3, **flags))
    jenv = jenvs.pendulum("tassa", "ad")
    jenv = dataclasses.replace(jenv, ilqr=dataclasses.replace(
        jenv.ilqr, iterations=3, **flags))
    if env.ilqr.control_limits:
        env = dataclasses.replace(env, model=_tight(env.model))
        jenv = dataclasses.replace(jenv, model=_tight(jenv.model))
    noise = np.array([[0.0, 0.6], [0.3, -0.2], [-0.8, 1.3]])
    states, sols = batch.init_batched(env, 3, qpos_noise=1.0, noise=noise,
                                      device="cpu")
    sol, trace = batch.make_batched_solve(env)(states, sols)

    jstates = JState(**_jtree(to_numpy(states)))
    jsols = jilqr.ILQRState(JState(**_jtree(to_numpy(sols.traj))),
                            jnp.asarray(sols.K.numpy()),
                            jnp.asarray(sols.k.numpy()),
                            jnp.asarray(sols.mu.numpy()))
    from ilqg_mujoco_tpu.parallel import batch as jbatch
    jsol, jtrace = jbatch.make_batched_solve(jenv)(jstates, jsols)
    tol = dict(rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(trace.numpy(), np.asarray(jtrace), **tol)
    np.testing.assert_allclose(sol.traj.qpos.numpy(),
                               np.asarray(jsol.traj.qpos), **tol)
    np.testing.assert_allclose(sol.traj.qvel.numpy(),
                               np.asarray(jsol.traj.qvel), **tol)
    np.testing.assert_allclose(sol.traj.ctrl.numpy(),
                               np.asarray(jsol.traj.ctrl), **tol)
    np.testing.assert_allclose(sol.K.numpy(), np.asarray(jsol.K), rtol=1e-9,
                               atol=1e-10)
    np.testing.assert_allclose(sol.k.numpy(), np.asarray(jsol.k), **tol)
    np.testing.assert_allclose(sol.mu.numpy(), np.asarray(jsol.mu),
                               rtol=1e-12)
    if env.ilqr.control_limits:
        assert float(sol.traj.ctrl.abs().max()) <= UMAX + 1e-12


def test_tassa_solve_decreases_cost_displaced():
    """tassa from a 0.6 rad displacement: monotone non-increasing trace
    (the linesearch guarantees descent) and a large net improvement
    (test_ilqr.py's counterpart)."""
    env = envs.pendulum("tassa", "ad")
    s0 = _states(env.model, [[0.0, 0.6]])
    sol0 = ilqr.init_solver(env.model, s0, env.ilqr)
    cost0 = float(ilqr._traj_cost(env.cost_fn, sol0.traj)[0])
    _, trace = ilqr.solve(env.model, env.cost_fn, s0, sol0, env.ilqr)
    trace = trace[0].numpy()
    assert np.all(np.diff(trace) <= 1e-9), trace
    assert trace[-1] < 0.1 * cost0, (trace, cost0)


def test_tassa_mpc_rebases_on_state_drift():
    """Under MPC the acceptance baseline is the feedback rollout from the
    current state, and the stored trajectory is rebased onto it even when
    no candidate improves (test_ilqr.py's counterpart)."""
    env = envs.pendulum()
    env = dataclasses.replace(env, ilqr=dataclasses.replace(
        env.ilqr, mode="tassa", iterations=3,
        lin=dataclasses.replace(env.ilqr.lin, engine="ad")))
    s0, sol0 = mpc.init(env, device="cpu")
    sol1, tr1 = ilqr.solve(env.model, env.cost_fn, s0, sol0, env.ilqr)
    s_bad = s0.replace(qpos=s0.qpos + torch.tensor([0.4, 0.9]),
                       qvel=s0.qvel + 1.0)
    sol2, tr2 = ilqr.solve(env.model, env.cost_fn, s_bad, sol1, env.ilqr)
    # the stored trajectory is rooted at the new state whatever was accepted
    assert torch.equal(sol2.traj.qpos[:, 0], s_bad.qpos)
    # the reported trace reflects rollouts from s_bad, not the stale cost
    assert float(tr2[0, 0]) > float(tr1[0, -1])
    assert np.all(np.diff(tr2[0].numpy()) <= 1e-6)


def test_tassa_mpc_frames_pass_mu_through():
    """Two batched MPC frames in tassa mode keep a per-instance mu (B,)
    that the solve adapts, and finite costs."""
    env = envs.pendulum("tassa", "ad")
    env = dataclasses.replace(env, ilqr=dataclasses.replace(env.ilqr,
                                                            iterations=2))
    states, sols = batch.init_batched(
        env, 2, generator=torch.Generator().manual_seed(0), device="cpu")
    step = batch.make_batched_mpc_step(env)
    s, so = states, sols
    for _ in range(2):
        s, so, cost = step(s, so)
        assert cost.shape == (2,) and bool(torch.isfinite(cost).all())
    assert so.mu.shape == (2,) and not torch.equal(so.mu, sols.mu)


def test_config_flag_guards():
    """The port's ILQRConfig accepts and refuses what the JAX package's
    does (test_ilqr.py::test_config_flag_guards), checked over every
    combination of the flags."""
    import itertools
    from ilqg_mujoco_tpu.ilqr import ILQRConfig as JCfg

    def outcome(cls, **kw):
        """None, or the first word of the refusal (the field it names)."""
        try:
            cls(**kw)
            return None
        except ValueError as e:
            return str(e).split()[0]

    for mode, bwd, cl, vs in itertools.product(
            ("compat", "tassa", "bogus"), ("scan", "assoc", "bogus"),
            (False, True), (False, True)):
        kw = dict(mode=mode, backward=bwd, control_limits=cl,
                  value_scaling=vs)
        assert outcome(ilqr.ILQRConfig, **kw) == outcome(JCfg, **kw), kw
    with pytest.raises(ValueError, match="control_limits"):
        ilqr.ILQRConfig(mode="tassa", backward="assoc", control_limits=True)
    with pytest.raises(ValueError, match="value_scaling"):
        ilqr.ILQRConfig(mode="tassa", backward="assoc", value_scaling=True)
    defaults = {f.name: f.default for f in dataclasses.fields(JCfg)
                if f.name != "lin"}
    assert {f.name: f.default for f in dataclasses.fields(ilqr.ILQRConfig)
            if f.name != "lin"} == defaults


@pytest.fixture(scope="module")
def amplified_pendulum():
    """test_value_scaling.py's stress: a pendulum linearization with A
    scaled to |A|~3 over N=120, the stiff-contact value-growth regime."""
    env = envs.pendulum("tassa", "ad")
    m = env.model
    s = _states(m, [[0.1, 0.3]])
    cfg = dataclasses.replace(env.ilqr, horizon=120, iterations=1)
    sol = ilqr.init_solver(m, s, cfg)
    lin = linearize_traj(m, sol.traj, env.cost_fn, cfg.lin)
    return env, m, cfg, sol.traj, lin._replace(A=3.0 * lin.A)


def test_plain_f32_overflows_scaled_does_not(amplified_pendulum):
    """Plain float32 gives non-finite gains; scaled float32 gives finite
    gains whose horizon-wide closed-loop transition shrinks the open-loop
    growth by many orders of magnitude (test_value_scaling.py)."""
    env, m, cfg, traj, lin = amplified_pendulum
    mu = torch.tensor([1e-6], dtype=torch.float64)
    K64 = ilqr.backward_pass_tassa(m, traj, lin, env.cost_fn, mu, cfg)[0]
    assert bool(torch.isfinite(K64).all())

    to32 = lambda x: x.to(torch.float32)
    traj32, lin32 = traj.map(to32), lin._replace(**{
        f: to32(getattr(lin, f)) for f in lin._fields})
    Kp, kp, _, _, okp = ilqr.backward_pass_tassa(m, traj32, lin32,
                                                 env.cost_fn, to32(mu), cfg)
    assert (not bool(torch.isfinite(Kp).all())
            or not bool(torch.isfinite(kp).all()) or not bool(okp.all()))
    cfg_s = dataclasses.replace(cfg, value_scaling=True)
    Ks, ks, *_ = ilqr.backward_pass_tassa(m, traj32, lin32, env.cost_fn,
                                          to32(mu), cfg_s)
    assert bool(torch.isfinite(Ks).all()) and bool(torch.isfinite(ks).all())

    A, B = lin.A[0].numpy(), lin.B[0].numpy()

    def prod_norm(K):
        P = np.eye(A.shape[-1])
        for t in range(cfg.horizon):
            M = A[t] if K is None else A[t] + B[t] @ K[0, t].double().numpy()
            P = M @ P
        return np.linalg.norm(P, 2)

    open_loop = prod_norm(None)
    assert prod_norm(K64) < 1e-10 * open_loop
    assert prod_norm(Ks) < 1e-20 * open_loop


def test_scaled_solve_descends():
    """A value-scaled tassa solve still descends (test_value_scaling.py)."""
    env = envs.pendulum("tassa", "ad")
    m = env.model
    s = _states(m, [[0.1, 0.5]])
    cfg = dataclasses.replace(env.ilqr, iterations=6, value_scaling=True)
    _, trace = ilqr.solve(m, env.cost_fn, s, ilqr.init_solver(m, s, cfg),
                          cfg)
    tr = trace[0].numpy()
    assert np.all(np.isfinite(tr)) and tr[-1] < tr[0]


@pytest.mark.slow
def test_long_horizon_T100_tassa_converges():
    """T=100 with the exact engine: where the compat recursion diverges,
    tassa solves stably to a local optimum (test_golden_compat.py's
    counterpart)."""
    env = envs.pendulum("tassa", "exact")
    env = dataclasses.replace(
        env, ilqr=dataclasses.replace(env.ilqr, horizon=100, iterations=15))
    s0, sol0 = mpc.init(env, device="cpu")
    sol, trace = ilqr.solve(env.model, env.cost_fn, s0, sol0, env.ilqr)
    trace = trace[0].numpy()
    assert np.all(np.isfinite(trace))
    assert np.all(np.diff(trace) <= 1e-9)
    assert trace[-1] < 0.92 * trace[0]
    assert float(sol.mu[0]) < 1.0
