"""Partitioning utilities: per-device splits and pooling."""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from repro_torch.data.federated import DeviceData
from repro_torch.utils.seeds import derive_device_seed  # noqa: F401  (re-exported,
# as in the reference package, where every engine tier imports it from here)


def split_train_test_val(
    device: DeviceData, seed: int = 0, fractions=(0.5, 0.4, 0.1)
) -> Dict[str, DeviceData]:
    """Paper protocol: 50/40/10 train/test/validation split per device.

    Tiny devices whose rounded train+test allotment consumes every
    sample draw their validation point from the TEST remainder — never
    from train, which would leak training data into the val AUC that
    drives cv selection.
    """
    assert abs(sum(fractions) - 1.0) < 1e-9
    rng = np.random.default_rng(seed)
    n = device.n
    perm = rng.permutation(n)
    n_train = max(int(round(fractions[0] * n)), 1)
    n_test = max(int(round(fractions[1] * n)), 1)
    idx_train = perm[:n_train]
    idx_test = perm[n_train : n_train + n_test]
    idx_val = perm[n_train + n_test :]
    if len(idx_val) == 0:  # tiny devices: borrow val from the test remainder
        if len(idx_test) > 1:
            idx_val, idx_test = idx_test[-1:], idx_test[:-1]
        else:  # degenerate 2-point device: share the single test point
            idx_val = idx_test[:1]
    mk = lambda idx: DeviceData(x=device.x[idx], y=device.y[idx])
    return {"train": mk(idx_train), "test": mk(idx_test), "val": mk(idx_val)}


def pool_devices(devices: List[DeviceData]) -> DeviceData:
    """Aggregate all device data (the paper's 'unattainable ideal' input)."""
    return DeviceData(
        x=np.concatenate([d.x for d in devices], axis=0),
        y=np.concatenate([d.y for d in devices], axis=0),
    )
