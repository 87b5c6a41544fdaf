"""Small shared utilities (``nufhe_tpu/utils/__init__.py``'s counterpart),
on numpy arrays or torch tensors on any device, and the profiler hooks
(``profiling.py``)."""

import numpy as np
import torch

from .profiling import profile_trace, annotate


def to_numpy(x):
    """A numpy array of ``x`` (a tensor is copied from its device)."""
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def to_device(x, device):
    """``x`` (a numpy array or a tensor) as a tensor on ``device``."""
    if not torch.is_tensor(x):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device)


def arrays_equal(a, b):
    """Exact equality of two arrays or tensors (shape and values)."""
    a, b = to_numpy(a), to_numpy(b)
    return a.shape == b.shape and bool((a == b).all())


def errors_allclose(a, b, rtol=1e-3, atol=1e-8):
    """Comparison for accumulated float32 noise variances
    (the reference tests' tolerance, ``test/utils.py:60-64``)."""
    return np.allclose(to_numpy(a), to_numpy(b), rtol=rtol, atol=atol)
