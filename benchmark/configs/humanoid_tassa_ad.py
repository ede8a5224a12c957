"""The humanoid's step cost, the plain reference's copy: stay tall, upright
and centred, hold the posture qpos0[7:], with velocity and ctrl penalties
(the JAX package's extension; the reference ships the model without one)."""

import torch


def make_cost(model):
    posture = {}

    def cost(qpos, qvel, ctrl):
        key = (qpos.device, qpos.dtype)
        if key not in posture:
            posture[key] = torch.as_tensor(model.qpos0[7:], dtype=qpos.dtype,
                                           device=qpos.device)
        up = 1.0 - 2.0 * (qpos[..., 4] ** 2 + qpos[..., 5] ** 2)
        return (50.0 * (qpos[..., 2] - 1.4) ** 2
                + 20.0 * (1.0 - up) ** 2
                + 1.0 * (qpos[..., 0] ** 2 + qpos[..., 1] ** 2)
                + 2.0 * ((qpos[..., 7:] - posture[key]) ** 2).sum(-1)
                + 0.05 * (qvel ** 2).sum(-1)
                + 1e-3 * (ctrl ** 2).sum(-1))
    return cost
