"""The training loop (counterpart of ``repro.train``)."""
from repro_torch.train.loop import Trainer, TrainerConfig

__all__ = ["Trainer", "TrainerConfig"]
