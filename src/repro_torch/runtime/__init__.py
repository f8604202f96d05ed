"""Serving runtime of the port."""
from .serve import Engine, Request

__all__ = ["Engine", "Request"]
