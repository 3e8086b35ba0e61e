"""The shared code of the benchmark: runners, traffic, trace reduction."""
