"""Serving and training runtimes of the port."""
from .serve import Engine, Request, Server
from .train_loop import Trainer, TrainerConfig, make_train_step

__all__ = ["Engine", "Request", "Server", "Trainer", "TrainerConfig",
           "make_train_step"]
