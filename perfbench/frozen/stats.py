"""Order statistics the benchmark reports, in one place."""

from __future__ import annotations

import numpy as np


def percentile(values, q: float) -> float:
    """numpy's linear-interpolation percentile ``q`` (0-100)."""
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def median(values) -> float:
    return percentile(values, 50.0)
