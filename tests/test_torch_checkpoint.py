"""The port's checkpoints (``repro_torch.checkpoint``) against the
reference's on the CPU: a tree of dicts, lists and tuples saved by
either package restores in the other with equal keys, shapes, dtypes and
values; wire payloads round-trip exactly across packages; the manifest
carries the reference's fields; ``CheckpointManager`` keeps
``max_to_keep``."""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import manager as ref_ckpt
from repro.comm import wire as ref_wire
from repro.core.svm import SVMModel as RefSVM
from repro.utils.seeds import derive_stream_seed
from repro_torch import checkpoint as pt_ckpt_pkg
from repro_torch.checkpoint import manager as pt_ckpt
from repro_torch.comm import payload_to_tree, tree_to_payload
from repro_torch.comm import wire as pt_wire
from repro_torch.utils.trees import (
    tree_flatten_with_path,
    tree_leaves,
    tree_structure,
    tree_unflatten,
)

# one intra-op thread: pytest-xdist workers run whole files side by side,
# and torch's default of a thread a core would oversubscribe the host
torch.set_num_threads(1)


def _rng(purpose: str) -> np.random.Generator:
    return np.random.default_rng(derive_stream_seed(29, purpose))


def _tree(rng):
    """Dicts (unsorted keys), lists, tuples, a None subtree and numpy
    leaves of several dtypes and ranks."""
    return {
        "w": rng.normal(size=(3, 4)).astype(np.float32),
        "layers": [
            {"b": rng.normal(size=4).astype(np.float32), "scale": np.float32(0.5)},
            (rng.integers(0, 9, size=(2, 2)).astype(np.int32),
             rng.normal(size=(5,)).astype(np.float16)),
        ],
        "a_meta": {"step": np.asarray(7, np.int64), "none": None},
        "q": rng.integers(-128, 128, size=(6, 2)).astype(np.int8),
    }


def _torch_like(tree):
    """The same structure with torch leaves where the leaf is an array
    (the scalar leaf stays numpy)."""
    from repro_torch.utils.trees import tree_map

    return tree_map(lambda a: torch.from_numpy(np.array(a)) if np.ndim(a) else a, tree)


def _assert_same(got, want):
    assert tree_structure(got) == tree_structure(want)
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        a_np = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        b_np = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        assert a_np.dtype == b_np.dtype and a_np.shape == b_np.shape
        assert a_np.tobytes() == b_np.tobytes()


def test_flatten_keys_are_jax_paths():
    tree = _tree(_rng("keys"))
    ref, _ = ref_ckpt._flatten_with_paths(tree)
    got = tree_flatten_with_path(tree)
    assert [k for k, _ in got] == list(ref)
    for (_, leaf), want in zip(got, ref.values()):
        assert np.asarray(leaf).tobytes() == want.tobytes()
    assert [k for k, _ in tree_flatten_with_path(np.zeros(2))] == [""]   # a bare leaf


def test_unflatten_rebuilds_the_tree_and_checks_the_count():
    tree = _tree(_rng("unflatten"))
    back = tree_unflatten(tree_structure(tree), tree_leaves(tree))
    _assert_same(back, tree)
    assert isinstance(back["layers"][1], tuple) and back["a_meta"]["none"] is None
    with pytest.raises(ValueError, match="fewer leaves"):
        tree_unflatten(tree_structure(tree), tree_leaves(tree)[:-1])
    with pytest.raises(ValueError, match="more leaves"):
        tree_unflatten(tree_structure(tree), tree_leaves(tree) + [1])


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    tree = _tree(_rng("ref_to_pt"))
    ref_ckpt.save_checkpoint(str(tmp_path / "ref"), tree, step=3)
    like = _torch_like(tree)
    got = pt_ckpt.restore_checkpoint(str(tmp_path / "ref"), like)
    assert isinstance(got["w"], torch.Tensor) and got["w"].dtype == torch.float32
    assert isinstance(got["layers"][0]["scale"], np.ndarray)
    _assert_same(got, like)
    # numpy ``like`` leaves come back as numpy arrays of their dtype
    _assert_same(pt_ckpt.restore_checkpoint(str(tmp_path / "ref"), tree), tree)


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    tree = _tree(_rng("pt_to_ref"))
    pt_ckpt.save_checkpoint(str(tmp_path / "pt"), _torch_like(tree), step=3)
    ref_ckpt.save_checkpoint(str(tmp_path / "ref"), tree, step=3)
    jax_like = {k: v for k, v in tree.items()}
    jax_like["w"] = jnp.asarray(tree["w"])
    got = ref_ckpt.restore_checkpoint(str(tmp_path / "pt"), jax_like)
    _assert_same({**got, "w": np.asarray(got["w"])}, tree)
    manifests = [json.loads((tmp_path / d / "manifest.json").read_text()) for d in ("pt", "ref")]
    for field in ("step", "keys", "nbytes"):
        assert manifests[0][field] == manifests[1][field]
    assert set(manifests[0]) == set(manifests[1]) == {"step", "keys", "treedef", "nbytes"}


def test_restore_checks_keys_and_shapes(tmp_path):
    tree = _tree(_rng("checks"))
    pt_ckpt.save_checkpoint(str(tmp_path / "c"), tree)
    with pytest.raises(KeyError, match="checkpoint missing 'extra'"):
        pt_ckpt.restore_checkpoint(str(tmp_path / "c"), {**tree, "extra": np.zeros(2)})
    with pytest.raises(ValueError, match="shape mismatch for w"):
        pt_ckpt.restore_checkpoint(str(tmp_path / "c"), {**tree, "w": torch.zeros(4, 3)})


def test_restore_keeps_the_like_leaf_dtype_and_device(tmp_path):
    pt_ckpt.save_checkpoint(str(tmp_path / "c"), {"x": np.arange(6, dtype=np.float64)})
    got = pt_ckpt.restore_checkpoint(str(tmp_path / "c"),
                                     {"x": torch.zeros(6, dtype=torch.float16)})
    assert got["x"].dtype == torch.float16 and got["x"].device.type == "cpu"
    assert got["x"].tolist() == list(range(6))


def test_payloads_round_trip_exactly_across_packages(tmp_path):
    rng = _rng("payload")
    model = RefSVM(rng.normal(size=(9, 5)).astype(np.float32),
                   rng.normal(size=9).astype(np.float32), 0.3)
    for codec in ("fp32", "int8", "fp16"):
        blob = ref_wire.encode(model, codec)
        assert tree_to_payload(payload_to_tree(blob)) == blob
        assert payload_to_tree(blob)["wire"].tobytes() == \
            ref_wire.payload_to_tree(blob)["wire"].tobytes()
        ref_path = ref_ckpt.save_payload(str(tmp_path / f"ref_{codec}"), blob, step=1)
        pt_path = pt_ckpt_pkg.save_payload(str(tmp_path / f"pt_{codec}"), blob, step=1)
        assert pt_ckpt_pkg.restore_payload(ref_path) == blob
        assert ref_ckpt.restore_payload(pt_path) == blob
        assert pt_wire.encode(pt_wire.decode(pt_ckpt_pkg.restore_payload(pt_path),
                                             device="cpu"), codec) == blob


def test_checkpoint_manager_keeps_max_to_keep(tmp_path):
    mgr = pt_ckpt_pkg.CheckpointManager(str(tmp_path / "run"), max_to_keep=2)
    assert mgr.restore_latest({"x": np.zeros(2)}) == (None, None)
    for step in (1, 5, 3, 9):
        mgr.save(step, {"x": np.full(2, step, np.float32)})
    assert mgr.all_steps() == [5, 9]
    assert sorted(os.listdir(tmp_path / "run")) == ["step_00000005", "step_00000009"]
    tree, step = mgr.restore_latest({"x": torch.zeros(2)})
    assert step == 9 and tree["x"].tolist() == [9.0, 9.0]
    # the reference's manager reads the port's directories
    ref = ref_ckpt.CheckpointManager(str(tmp_path / "run"), max_to_keep=2)
    got, step = ref.restore_latest({"x": np.zeros(2, np.float32)})
    assert step == 9 and got["x"].tolist() == [9.0, 9.0]
