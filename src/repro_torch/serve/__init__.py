"""Serving layer of the port — two engines: the LM's continuous-batching
``Engine`` (token decode over fixed slots, serve/engine.py, with
``sample``, serve/sampler.py) and the k-center query service
``KCenterService`` (batched nearest-center assignment over a live
streamed sketch, serve/kcenter.py)."""
from .engine import Engine, Request
from .kcenter import AssignResult, AssignTicket, KCenterService
from .sampler import sample

__all__ = [
    "Engine",
    "Request",
    "sample",
    "KCenterService",
    "AssignResult",
    "AssignTicket",
]
