"""Throughput accounting: the port's copy of ``gcups`` from the JAX
package's ``utils/observability.py``."""

from __future__ import annotations


def gcups(cells: int, seconds: float) -> float:
    """Billions of DP cell updates per second."""
    return cells / seconds / 1e9 if seconds > 0 else float("inf")
