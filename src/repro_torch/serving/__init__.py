"""Serving (counterpart of ``repro.serving``): the engine, the batch
scheduler and the InferenceServer."""

from repro_torch.serving.engine import PhoneBitEngine
from repro_torch.serving.scheduler import BatchScheduler, Request, buckets_for
from repro_torch.serving.server import InferenceServer

__all__ = ["BatchScheduler", "InferenceServer", "PhoneBitEngine", "Request",
           "buckets_for"]
