"""Train, eval and test loops of the port; ``train(cfg)`` and ``test(cfg)``
are the entry points."""

from .test_loop import test
from .train_loop import train

__all__ = ["test", "train"]
