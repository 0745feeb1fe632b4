"""The percentile of the program's ``serving/metrics.py`` (numpy's linear
interpolation), copied so the yardstick does not move with the program."""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def percentile(vals: Sequence[float], p: float) -> Optional[float]:
    """The ``p``-th percentile, or None for no samples."""
    if not len(vals):
        return None
    return float(np.percentile(np.asarray(vals, dtype=np.float64), p))

