from repro_torch.runtime.trainer import StepStats, TrainLoop, TrainLoopConfig

__all__ = ["StepStats", "TrainLoop", "TrainLoopConfig"]
