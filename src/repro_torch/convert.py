"""Carry trained state across from the reference package.

The reference keeps a trained ``SVMModel`` as host arrays
(``support_x``, ``coef``, ``gamma``), a packed ``StackedEnsemble`` as
``sup``/``coef``/``gammas`` arrays, and their int8 forms (``QuantizedSVM``,
``QuantizedStackedEnsemble``) as ``q``/``scale``/``zero``/``coef`` plus
gamma(s), a ``LinearSVM`` as ``w`` and ``b``, and an aggregator's
``AggExtra`` as a dict of named arrays. These functions take those arrays (as numpy, e.g.
``np.asarray`` of the reference's fields) and return the port's objects,
so a model trained by either package scores in the other. The wire
format (``comm.wire``) is the other carrier: a blob of any codec from
either package decodes in the other.

``lm_params_from_arrays`` carries an LM's parameter tree across: the
reference's nested dict of arrays, whose blocks are stacked on a leading
``n_superblocks`` axis per sub-layer kind, becomes the port's module with
one entry per layer.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.comm.wire import AggExtra, QuantizedStackedEnsemble, QuantizedSVM
from repro_torch.core.averaging import LinearSVM
from repro_torch.core.ensemble import StackedEnsemble
from repro_torch.core.svm import SVMModel
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import materialize, model_specs
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


def quantized_svm_from_arrays(q, scale, zero, coef, gamma: float,
                              device="cuda") -> QuantizedSVM:
    """A reference ``QuantizedSVM``'s fields -> the port's, scored on
    ``device`` through the ``rbf_gram_q8`` kernel."""
    dev = resolve_device(device)
    qa = np.array(q, np.int8)
    sc, ze, c = (np.array(a, np.float32) for a in (scale, zero, coef))
    n, d = qa.shape if qa.ndim == 2 else (-1, -1)
    if qa.ndim != 2 or sc.shape != (d,) or ze.shape != (d,) or c.shape != (n,):
        raise ValueError(f"q (n, d), scale (d,), zero (d,), coef (n,) disagree: "
                         f"{qa.shape}, {sc.shape}, {ze.shape}, {c.shape}")
    return QuantizedSVM(q=qa, scale=sc, zero=ze, coef=c, gamma=float(gamma),
                        device=str(dev))


def quantized_stacked_from_arrays(q, scale, zero, coef, gammas,
                                  device="cuda") -> QuantizedStackedEnsemble:
    """A reference ``QuantizedStackedEnsemble``'s arrays -> the port's
    module, its int8 and fp32 buffers on ``device``."""
    dev = resolve_device(device)
    qa = np.array(q, np.int8)
    sc, ze, c, g = (np.array(a, np.float32) for a in (scale, zero, coef, gammas))
    if (qa.ndim != 3 or sc.shape != (qa.shape[0], qa.shape[2]) or ze.shape != sc.shape
            or c.shape != qa.shape[:2] or g.shape != (qa.shape[0],)):
        raise ValueError(f"q (k, n_max, d), scale and zero (k, d), coef (k, n_max), "
                         f"gammas (k,) disagree: {qa.shape}, {sc.shape}, {ze.shape}, "
                         f"{c.shape}, {g.shape}")
    return QuantizedStackedEnsemble(*(torch.from_numpy(a).to(dev)
                                      for a in (qa, sc, ze, c, g)))


def linear_from_arrays(w, b: float, device="cuda") -> LinearSVM:
    """A reference ``LinearSVM``'s fields -> the port's, scored on ``device``."""
    dev = resolve_device(device)
    wa = np.array(w, np.float32)
    if wa.ndim != 1:
        raise ValueError(f"w must be (d,), got {wa.shape}")
    return LinearSVM(w=wa, b=float(b), device=str(dev))


def agg_extra_from_arrays(arrays) -> AggExtra:
    """A reference ``AggExtra``'s named arrays -> the port's (float32
    host copies, names and order kept)."""
    return AggExtra({str(k): np.array(v, np.float32) for k, v in arrays.items()})


def lm_params_from_arrays(tree, cfg: ModelConfig, device="cuda", trainable: bool = False):
    """A reference LM parameter tree (``repro.models.init_params``'s
    layout, leaves as numpy arrays, e.g. ``jax.tree.map(np.asarray, p)``)
    -> the port's parameter module on ``device``. Layer ``i`` of the port
    is superblock ``i // period`` of the reference's sub-layer kind
    ``i % period``. Values are carried exactly (bf16 through fp32). The
    parameters require grad when ``trainable`` (for ``make_train_step``)."""
    dev = resolve_device(device)
    period = len(cfg.sublayer_kinds())

    def leaf(path, spec):
        if path[0] == "blocks":
            node = tree["blocks"][path[1] % period]
            for key in path[2:]:
                node = node[key]
            arr = np.asarray(node)[path[1] // period]
        else:
            arr = np.asarray(tree[path[0]])
        if tuple(arr.shape) != spec.shape:
            raise ValueError(f"{'/'.join(map(str, path))}: reference array {arr.shape}, "
                             f"config wants {spec.shape}")
        return torch.from_numpy(np.array(arr, np.float32)).to(dev, spec.dtype)

    return materialize(model_specs(cfg), leaf, trainable=trainable)
