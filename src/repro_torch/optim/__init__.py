"""The centralized Adam oracle (``adam``) and the LR schedules
(``schedules``), the port of ``repro.optim``."""
from repro_torch.optim import adam, schedules

__all__ = ["adam", "schedules"]
