"""The scheduler_perf-style workloads and their harness, on the port
(the JAX package's perf/workloads.py and perf/harness.py, trimmed to the
suites and opcodes the port runs)."""
