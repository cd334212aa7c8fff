"""The gradient pipeline (``grad``), the decentralized trainer (``loop``),
adaptive batch damping (``damping``), the evaluation metrics (``metrics``)
and the online train->serve loop (``online``)."""
from repro_torch.train.damping import (DampingConfig, DampingState,
                                       make_damping)
from repro_torch.train.grad import GradPipeline, make_grad_pipeline
from repro_torch.train.loop import (DecentralizedTrainer, TrainLog,
                                    stack_params, stacked_loss)
from repro_torch.train.online import OnlineResult, train_online

__all__ = ["DecentralizedTrainer", "TrainLog", "stack_params",
           "stacked_loss", "GradPipeline", "make_grad_pipeline",
           "DampingConfig", "DampingState", "make_damping",
           "OnlineResult", "train_online"]
