"""Host<->device transfer helpers."""

from __future__ import annotations

import numpy as np


def asnumpy(x) -> np.ndarray:
    """Download a jax array (or pass a numpy array through) to host numpy."""
    return x if isinstance(x, np.ndarray) else np.asarray(x)
