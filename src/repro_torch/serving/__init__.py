"""Serving layer of the port: sessions, the slot scheduler, the engine."""
from repro_torch.serving.engine import Engine, StepStats
from repro_torch.serving.scheduler import SlotScheduler
from repro_torch.serving.session import Session

__all__ = ["Engine", "SlotScheduler", "Session", "StepStats"]
