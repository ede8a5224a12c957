"""The cart-pole's step cost, the plain reference's copy
(reference inc/inverted_pendulum/cost.h:7-17)."""


def make_cost(model):
    def cost(qpos, qvel, ctrl):
        return (1.0 * qpos[..., 0] ** 2 + 10.0 * qpos[..., 1] ** 2
                + 1.0 * qvel[..., 0] ** 2 + 10.0 * qvel[..., 1] ** 2
                + 1.0 * ctrl[..., 0] ** 2)
    return cost
