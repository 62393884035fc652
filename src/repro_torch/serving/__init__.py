"""serving subsystem: LM decode serving (serving/engine.py) over the
continuous-batching slot table (serving/slots.py). The env service waits
for its port (ROADMAP A11)."""
from repro_torch.serving.slots import SlotTable, percentile

__all__ = ["SlotTable", "percentile"]
