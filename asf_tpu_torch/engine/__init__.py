"""Train and eval loops of the port; ``train(cfg)`` is the training entry point."""

from .train_loop import train

__all__ = ["train"]
