"""Synthetic federated datasets and per-client LM token sources
(copies of the reference's generators)."""
from repro_torch.data.federated import (
    DATASETS,
    DeviceData,
    FederatedDataset,
    make_cohort_dataset,
    make_dataset,
    make_emnist_like,
    make_gleam_like,
    make_sent140_like,
)
from repro_torch.data.lm_data import make_federated_lm_data, token_batches
from repro_torch.data.partition import dirichlet_partition, pool_devices, split_train_test_val

__all__ = [
    "DATASETS",
    "DeviceData",
    "FederatedDataset",
    "dirichlet_partition",
    "make_cohort_dataset",
    "make_dataset",
    "make_emnist_like",
    "make_gleam_like",
    "make_sent140_like",
    "make_federated_lm_data",
    "pool_devices",
    "split_train_test_val",
    "token_batches",
]
