"""The one-shot communication substrate: fp32 wire format, ledger,
model exchange."""
