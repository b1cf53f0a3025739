"""Serving layer of the port: the online k-center query service
``KCenterService`` (batched nearest-center assignment over a live streamed
sketch, serve/kcenter.py). The JAX package's LM serving engine (``Engine``,
``Request``, ``sample``) comes with the port's LM stack."""
from .kcenter import AssignResult, AssignTicket, KCenterService

__all__ = [
    "KCenterService",
    "AssignResult",
    "AssignTicket",
]
