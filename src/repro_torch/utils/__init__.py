"""Host utilities of the port: seeds, metrics, logging, device policy."""
