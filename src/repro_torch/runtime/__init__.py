"""The fault-tolerant training loop (``repro.runtime``'s counterpart)."""

from repro_torch.runtime.loop import FailureInjector, TrainLoopRunner

__all__ = ["TrainLoopRunner", "FailureInjector"]
