"""The port's benchmark: one command runs one cell of BENCHMARK.json on the
card (run.py); see README.md."""
