"""Small shared utilities (``nufhe_tpu/utils/__init__.py``'s counterpart),
on numpy arrays or torch tensors on any device."""

import numpy as np
import torch


def _host(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def arrays_equal(a, b):
    """Exact equality of two arrays or tensors (shape and values)."""
    a, b = _host(a), _host(b)
    return a.shape == b.shape and bool((a == b).all())


def errors_allclose(a, b, rtol=1e-3, atol=1e-8):
    """Comparison for accumulated float32 noise variances
    (the reference tests' tolerance, ``test/utils.py:60-64``)."""
    return np.allclose(_host(a), _host(b), rtol=rtol, atol=atol)
