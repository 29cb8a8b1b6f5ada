"""repro_torch.roofline — the three-term roofline model and the card's
sheets (``H100_SXM`` bf16, ``H100_SXM_FP32``), beside the reference's
``V5E``. ``analytic.inner_scan_cost`` and ``report`` are imported from
their modules."""
from repro_torch.roofline.analysis import (
    H100_SXM,
    H100_SXM_FP32,
    V5E,
    HardwareSpec,
    collective_bytes_from_hlo,
    roofline_report,
)

__all__ = ["V5E", "H100_SXM", "H100_SXM_FP32", "HardwareSpec", "collective_bytes_from_hlo",
           "roofline_report"]
