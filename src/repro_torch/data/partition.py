"""Partitioning utilities: per-device splits, pooling and Dirichlet
non-IID sharding."""
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


def dirichlet_partition(
    x: np.ndarray, y: np.ndarray, n_devices: int, alpha: float = 0.3, seed: int = 0
) -> List[DeviceData]:
    """Classic non-IID federated partition: per-class Dirichlet allocation.

    Lower ``alpha`` -> more skewed per-device label distributions.
    """
    if len(y) < n_devices:
        raise ValueError(f"cannot give {n_devices} devices >=1 of {len(y)} samples")
    rng = np.random.default_rng(seed)
    classes = np.unique(y)
    device_indices: List[List[int]] = [[] for _ in range(n_devices)]
    for c in classes:
        idx = np.flatnonzero(y == c)
        rng.shuffle(idx)
        props = rng.dirichlet(alpha * np.ones(n_devices))
        cuts = (np.cumsum(props) * len(idx)).astype(int)[:-1]
        for dev, chunk in enumerate(np.split(idx, cuts)):
            device_indices[dev].extend(chunk.tolist())
    # guarantee non-empty devices WITHOUT duplicating samples: empty
    # devices steal one sample from the currently largest device, so
    # every sample is assigned to exactly one device.
    for dev in range(n_devices):
        if not device_indices[dev]:
            donor = max(range(n_devices), key=lambda d: len(device_indices[d]))
            device_indices[dev].append(device_indices[donor].pop())
    out = []
    for dev in range(n_devices):
        idx = np.array(sorted(device_indices[dev]), dtype=int)
        out.append(DeviceData(x=x[idx], y=y[idx]))
    return out
