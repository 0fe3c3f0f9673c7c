"""Serving: scheduler (admission) / sampler (token choice) / engine
(executor with the multi-token decode window), synchronous ring path."""

from repro_torch.serving.engine import Engine
from repro_torch.serving.policy import AdmissionPolicy, FifoPolicy, get_policy
from repro_torch.serving.sampler import SamplingParams
from repro_torch.serving.scheduler import Request, Scheduler

__all__ = ["AdmissionPolicy", "Engine", "FifoPolicy", "Request",
           "SamplingParams", "Scheduler", "get_policy"]
