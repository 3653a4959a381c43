"""Shared plumbing of the benchmark: the registry, processes, signing and
the profiler's reading."""
