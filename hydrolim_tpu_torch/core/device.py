"""Host constants onto the device without a host synchronisation.

A blocking host-to-device copy of pageable memory synchronises the stream
(and trips ``torch.cuda.set_sync_debug_mode``); a non-blocking one returns
once the CUDA runtime has staged the pageable buffer, so the source may go
away.  The engines build their constant arrays (anchor masks, smoothing
weights and kernels) with ``to_device`` so that a run issues no host
synchronisation between its setup and its result.
"""
from __future__ import annotations

import numpy as np
import torch


def to_device(a, device, dtype=None) -> torch.Tensor:
    """``a`` (array-like) as a tensor on ``device``, copied without a
    host synchronisation."""
    t = torch.from_numpy(np.ascontiguousarray(np.asarray(a)))
    if dtype is not None:
        t = t.to(dtype)
    return t.to(device, non_blocking=True)
