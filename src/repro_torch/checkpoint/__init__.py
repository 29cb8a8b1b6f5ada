"""repro_torch.checkpoint — trees and wire payloads <-> npz + manifest,
restorable across the port and the reference (``manager.py``)."""
from repro_torch.checkpoint.manager import (
    CheckpointManager,
    restore_checkpoint,
    restore_payload,
    save_checkpoint,
    save_payload,
)

__all__ = [
    "save_checkpoint", "restore_checkpoint", "CheckpointManager",
    "save_payload", "restore_payload",
]
