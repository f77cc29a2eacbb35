"""Serving layer of the port: sessions, the slot scheduler, the engine,
scheduling policies, telemetry and the workload generator."""
from repro_torch.serving.engine import Engine, StepStats
from repro_torch.serving.metrics import ServingTelemetry
from repro_torch.serving.policy import (DeadlineCostPolicy, FifoPolicy,
                                        SchedulingPolicy, get_policy)
from repro_torch.serving.scheduler import SlotScheduler
from repro_torch.serving.session import Session
from repro_torch.serving.workload import (Arrival, WorkloadSpec,
                                          generate_workload)

__all__ = ["Arrival", "DeadlineCostPolicy", "Engine", "FifoPolicy",
           "SchedulingPolicy", "ServingTelemetry", "Session",
           "SlotScheduler", "StepStats", "WorkloadSpec", "generate_workload",
           "get_policy"]
