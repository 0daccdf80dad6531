"""Coded SGD over the model zoo and the plain train, prefill and decode
steps (port of ``repro.train``)."""
from .coded import (CodedTrainer, TrainProblem, build_coded_train_step,
                    run_coded_sgd)
from .steps import (batch_extras, build_decode_step, build_prefill_step,
                    build_train_step)
from .trainer import Trainer, TrainerConfig
