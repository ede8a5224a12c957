"""The benchmark's plain reference: MuJoCo-semantics physics, the fd and
ad linearizers and the iLQR solve loops in eager PyTorch.

A frozen copy of ``ilqg_mujoco_torch``'s physics, linearizer and solver as
they stood when the benchmark was written (the port's slice 9), cut to what
the benchmark's configurations run: no CUDA graphs, no CUDA kernel, no
knot chunking, no control limits.  It imports nothing of the program, so a
later change to the program is judged against what this copy computes.
The program's tests hold that code to the JAX package and to the MuJoCo C
core; ``benchmark/tests`` hold this copy to the program at a small size.
"""
