"""The port's timing and artifact tools, the counterparts of the JAX
package's ``tools/perf_breakdown.py`` and ``tools/humanoid_balance.py``;
each runs as ``python -m ilqg_mujoco_torch.tools.<name>``."""
