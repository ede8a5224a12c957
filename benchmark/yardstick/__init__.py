"""What the benchmark measures the program with, kept apart from the
program so that a change to the program cannot move it: the seeded inputs,
the H100's peaks, the work of a solve and of the Riccati kernel, and the
phase arithmetic."""
