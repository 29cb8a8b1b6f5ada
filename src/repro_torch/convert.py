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
one entry per layer; ``lm_stacked_from_arrays`` splits the reference's
stacked members (``repro.core.deepfed.stacked_init``'s leading member
axis) into the port's list of member modules.
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
from repro_torch.utils.trees import tree_leaves, tree_map


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
    ``i % period``; encoder layer ``i`` is index ``i`` of the reference's
    stacked ``encoder/blocks``. Values are carried exactly (bf16 through
    fp32). The parameters require grad when ``trainable`` (for
    ``make_train_step``)."""
    dev = resolve_device(device)
    period = len(cfg.sublayer_kinds())

    def stacked(node, keys, index):
        for key in keys:
            node = node[key]
        return np.asarray(node)[index]

    def leaf(path, spec):
        if path[0] == "blocks":
            arr = stacked(tree["blocks"][path[1] % period], path[2:], path[1] // period)
        elif path[:2] == ("encoder", "blocks"):
            arr = stacked(tree["encoder"]["blocks"], path[3:], path[2])
        elif path[0] == "encoder":
            arr = np.asarray(tree["encoder"][path[1]])
        else:
            arr = np.asarray(tree[path[0]])
        if tuple(arr.shape) != spec.shape:
            raise ValueError(f"{'/'.join(map(str, path))}: reference array {arr.shape}, "
                             f"config wants {spec.shape}")
        return torch.from_numpy(np.array(arr, np.float32)).to(dev, spec.dtype)

    return materialize(model_specs(cfg), leaf, trainable=trainable)


def lm_stacked_from_arrays(tree, cfg: ModelConfig, device="cuda", trainable: bool = False):
    """The reference's stacked members (``repro.core.deepfed.stacked_init``:
    every leaf of ``init_params``' tree with a leading member axis M,
    leaves as numpy arrays) -> the port's list of M parameter modules,
    member m ``lm_params_from_arrays`` of the leaves' slice m."""
    sizes = {np.shape(leaf)[0] for leaf in tree_leaves(tree)}
    if len(sizes) != 1:
        raise ValueError(f"stacked members disagree on the member axis: {sorted(sizes)}")
    return [lm_params_from_arrays(tree_map(lambda a, m=m: np.asarray(a)[m], tree), cfg,
                                  device=device, trainable=trainable)
            for m in range(sizes.pop())]
