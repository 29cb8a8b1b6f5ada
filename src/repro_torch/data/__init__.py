"""Synthetic federated datasets (copies of the reference's generators)."""
from repro_torch.data.federated import (
    DATASETS,
    DeviceData,
    FederatedDataset,
    make_dataset,
)
from repro_torch.data.partition import pool_devices, split_train_test_val

__all__ = [
    "DATASETS",
    "DeviceData",
    "FederatedDataset",
    "make_dataset",
    "pool_devices",
    "split_train_test_val",
]
