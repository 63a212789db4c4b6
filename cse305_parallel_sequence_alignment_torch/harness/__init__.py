"""Harnesses that drive the port's kernels: the ``perf`` report."""
