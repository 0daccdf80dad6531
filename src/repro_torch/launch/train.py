"""CLI training launcher: coded data-parallel training with straggler
simulation (port of ``repro.launch.train``).  Every coded step combines
the workers' gradients with one launch of the combine kernel on the card.

  PYTHONPATH=src python -m repro_torch.launch.train --arch deepseek-7b \\
      --smoke --steps 50 --m-workers 8 --wait-k 6 --delay bimodal

``--device`` unset means the CUDA card (and an error without one), as for
every entry point of the port; ``--device cpu`` runs the plain PyTorch
path on the host.  ``train`` is the body, for callers that bring their own
configuration or initial parameters.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Callable, Optional

from repro_torch.configs import ARCHS
from repro_torch.configs.base import ArchConfig
from repro_torch.core.straggler import (bimodal_delays, constant_delays,
                                        exponential_delays,
                                        multimodal_delays, power_law_delays)
from repro_torch.models.common import Dtype
from repro_torch.optim import adamw_init
from repro_torch.train.trainer import Trainer, TrainerConfig

__all__ = ["DELAYS", "parser", "train", "main"]

DELAYS = {
    "bimodal": bimodal_delays,
    "powerlaw": power_law_delays,
    "exponential": exponential_delays,
    "multimodal": multimodal_delays,
    "none": lambda: constant_delays(0.0),
}


def parser() -> argparse.ArgumentParser:
    """The reference's flags, plus ``--device``."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="deepseek-7b", choices=sorted(ARCHS))
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-trainable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--m-workers", type=int, default=8)
    ap.add_argument("--beta", type=int, default=2)
    ap.add_argument("--wait-k", type=int, default=6)
    ap.add_argument("--rows-per-worker", type=int, default=2)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--delay", default="bimodal", choices=sorted(DELAYS))
    ap.add_argument("--uncoded", action="store_true",
                    help="baseline without redundancy")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--history-out", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap


def train(cfg: ArchConfig, args: argparse.Namespace, params=None, opt=None,
          callback: Optional[Callable] = None):
    """Train ``cfg`` as the parsed ``args`` say -> (params, optimizer state,
    history).  ``params`` (on ``args.device``) replace the trainer's
    seeded initialization, with ``opt`` or a zero AdamW state;
    ``callback(record)`` runs after each step, as ``CodedTrainer.run``'s
    does."""
    tcfg = TrainerConfig(
        m_workers=args.m_workers, beta=args.beta, wait_k=args.wait_k,
        rows_per_worker=args.rows_per_worker, seq_len=args.seq_len,
        steps=args.steps, lr=args.lr, checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=50 if args.checkpoint_dir else 0,
        uncoded=args.uncoded)
    trainer = Trainer(cfg, tcfg, delay_model=DELAYS[args.delay](),
                      device=args.device)
    if params is not None and opt is None:
        opt = adamw_init(params, dtype=Dtype.of(cfg.optstate_dtype))
    return trainer.run(params, opt, callback=callback)


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    cfg = ARCHS[args.arch]
    if args.smoke:
        cfg = cfg.smoke_variant()
    _, _, history = train(cfg, args)
    print(f"final loss: {history[-1]['loss']:.4f}; "
          f"simulated wall-clock: {history[-1]['sim_time_s']:.1f}s")
    if args.history_out:
        with open(args.history_out, "w") as f:
            json.dump(history, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
