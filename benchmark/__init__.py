"""The benchmark of ``ilqg_mujoco_torch``, the PyTorch and CUDA port.

``python benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line.  Everything a cell needs is found by name: its configuration in
``configs/``, its traffic mix in ``traffic/``, its correctness limits in
``checks/`` and each metric's reader in ``metrics/``.  ``yardstick/`` and
``reference/`` hold what later changes to the program must not move.
"""
