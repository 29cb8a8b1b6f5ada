"""Carry trained state across from the reference package.

The reference keeps a trained ``SVMModel`` as host arrays
(``support_x``, ``coef``, ``gamma``) and a packed ``StackedEnsemble`` as
``sup``/``coef``/``gammas`` arrays. These functions take those arrays
(as numpy, e.g. ``np.asarray`` of the reference's fields) and return
the port's objects, so a model trained by either package scores in the
other. The fp32 wire format (``comm.wire``) is the other carrier: a
blob from either package decodes in the other.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.ensemble import StackedEnsemble
from repro_torch.core.svm import SVMModel
from repro_torch.utils.device import resolve_device


def svm_from_arrays(support_x, coef, gamma: float, device="cuda") -> SVMModel:
    """A reference ``SVMModel``'s fields -> the port's ``SVMModel``."""
    dev = resolve_device(device)
    sup = np.asarray(support_x, np.float32)
    c = np.asarray(coef, np.float32)
    if sup.ndim != 2 or c.shape != (sup.shape[0],):
        raise ValueError(f"support_x (n, d) and coef (n,) disagree: "
                         f"{sup.shape}, {c.shape}")
    return SVMModel(support_x=sup, coef=c, gamma=float(gamma), device=str(dev))


def stacked_from_arrays(sup, coef, gammas, device="cuda") -> StackedEnsemble:
    """A reference ``StackedEnsemble``'s arrays -> the port's module,
    its buffers on ``device``."""
    dev = resolve_device(device)
    # copies: the reference's arrays may be read-only views of device memory
    s = np.array(sup, np.float32)
    c = np.array(coef, np.float32)
    g = np.array(gammas, np.float32)
    if s.ndim != 3 or c.shape != s.shape[:2] or g.shape != (s.shape[0],):
        raise ValueError(f"sup (k, n_max, d), coef (k, n_max), gammas (k,) "
                         f"disagree: {s.shape}, {c.shape}, {g.shape}")
    return StackedEnsemble(torch.from_numpy(s).to(dev), torch.from_numpy(c).to(dev),
                           torch.from_numpy(g).to(dev))
