"""Serving and training runtimes of the port."""
from .serve import Engine, Request
from .train_loop import Trainer, TrainerConfig, make_train_step

__all__ = ["Engine", "Request", "Trainer", "TrainerConfig",
           "make_train_step"]
