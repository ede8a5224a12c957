"""The yardstick's counts against values worked out by hand, and its
seeded inputs."""

import torch

from benchmark.yardstick import inputs, work


def test_riccati_work_by_hand():
    # Bt=2, N=3, n=4: elements 3*16 + 3*4 + 4*4 + 3 + 3*4 + 3*4 + 3 = 106 an
    # instance; operations 4*64 + 15*16 + 14*4 + 10 = 562 a step
    ops, nbytes = work.riccati_work(2, 3, 4, 8)
    assert ops == 2 * 3 * 562
    assert nbytes == 2 * 106 * 8


def test_pieces_by_hand():
    assert work.chol(3) == 9
    assert work.tri2(3) == 18
    assert work.pos_eval(2) == 12 * 4 + 8 / 3
    # nv 2, nefc 4: 4*4*2 + 2*4 + 2*4 = 48 a CG iteration
    assert work.cg_iter(2, 4) == 48
    assert work.acc_eval(2, 4, 30) == 8 + 32 + 30 * 48
    assert work.acc_eval(2, 0, 30) == 8
    assert work.riccati_compat_step(4) == 562
    # n 4, nu 2: 256 + 10*16*2 + 6*4*4 + 8/3
    assert work.tassa_step(4, 2) == 256 + 320 + 96 + 8 / 3


def test_iteration_flops_compat_by_hand():
    conf = {"nv": 2, "nu": 1, "nefc": 4, "horizon": 2, "integrator": "RK4",
            "mode": "compat", "alphas": [1.0],
            "lin": {"engine": "fd", "niter": 30, "nwarmup": 3}}
    pos = 48 + 8 / 3
    step = 4 * (pos + 8 + 32 + 48)              # RK4, CG at 1 iteration
    acc = 8 + 32 + 30 * 48                      # pinned
    knot = (pos + 3 * acc) + 4 * pos + 10 * acc
    want = 2 * step + 3 * knot + 2 * 562
    assert abs(work.iteration_flops(conf) - want) < 1e-6


def test_iteration_flops_tassa_ad_by_hand():
    conf = {"nv": 2, "nu": 1, "nefc": 4, "horizon": 2, "integrator": "Euler",
            "mode": "tassa", "alphas": [1.0, 0.5],
            "lin": {"engine": "ad", "niter": 30, "nwarmup": 3}}
    pos = 48 + 8 / 3
    step = pos + 8 + 32 + 48
    acc = 8 + 32 + 30 * 48
    knot = (pos + 3 * acc) + (2 * 4 * 4 + 8 / 3) + 5 * (32 + 8 + 8)
    back = 4 * 64 + 10 * 16 + 6 * 4 + 1 / 3
    want = 3 * 2 * step + 3 * knot + 2 * back
    assert abs(work.iteration_flops(conf) - want) < 1e-6


def test_inputs_repeat_from_the_seed():
    a = inputs.noise_pool(2 ** 31 + 9, 2, 3, 2, "cpu")
    b = inputs.noise_pool(2 ** 31 + 9, 2, 3, 2, "cpu")
    c = inputs.noise_pool(2 ** 31 + 10, 2, 3, 2, "cpu")
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert inputs.instances(5, 1, 100, 4) == inputs.instances(5, 1, 100, 4)
    assert len(set(inputs.instances(5, 1, 100, 4))) == 4
    pairs = [(s, i) for s in range(10) for i in range(2)]
    assert len(inputs.choose(3, pairs, 5)) == 5
    assert inputs.choose(3, pairs[:3], 5) == pairs[:3]
