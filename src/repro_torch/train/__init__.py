"""Coded SGD over the model zoo (port of ``repro.train``; the prefill /
decode / plain train steps of ``repro.train.steps`` wait for the serve
path, ROADMAP Queue 1 item 5)."""
from .coded import (CodedTrainer, TrainProblem, build_coded_train_step,
                    run_coded_sgd)
from .trainer import Trainer, TrainerConfig
