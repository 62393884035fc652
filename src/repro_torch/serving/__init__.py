"""serving subsystem: LM decode serving (serving/engine.py) and env session
serving (serving/env_service.py) over the shared continuous-batching slot
table (serving/slots.py)."""
from repro_torch.serving.env_service import EnvService, Session
from repro_torch.serving.slots import SlotTable, percentile

__all__ = ["EnvService", "Session", "SlotTable", "percentile"]
