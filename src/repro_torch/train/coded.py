"""repro_torch.train.coded — coded SGD bridging the model zoo to the runtime
(port of ``repro.train.coded``).

Per-worker minibatch gradients of a real neural LM flow through the
gradient-coding combine, and the training loop is driven by the SAME
``ClusterEngine`` schedules, active-set policies, fault injectors and
wall-clock accounting as every convex strategy.

Dataflow per step t:

    GroupBatcher ----> tokens/labels (m, g*rows, S), coeff (m, g*rows)
    Schedule.masks[t] -> code.decode_weights(mask)        (host, tiny)
    vmap(grad_and_value(worker_loss)) over the worker axis
        worker i: sum_r coeff[i,r] * CE_row_r / (rows * S)   [+ aux]
    gradient leaves (m, ...) copied straight into ONE preallocated
        (m, P_total) float32 block, in the reference's flatten order
    kernels.coded_reduce.coded_combine_call(block, decode) / num_groups
    optim.adamw_update

``torch.func.vmap`` batches the workers as the reference's ``jax.vmap``
does: one launch of each operation for all m workers, and each worker's
weight gradients its own batch of a batched product.  Every operation on
the path treats the workers' rows alike and sums in an order that does not
depend on the other workers' data (no atomics: the embedding's backward
for a few thousand indices sums each row in index order), so replicas that
hold the same rows produce the same bits and the FRC update does not
depend on which replica survived.  The per-row cross entropy uses a FIXED
denominator (rows * S tokens), not the self-normalizing ``lm_loss``
weight sum: gradients stay LINEAR in the combine coefficients, so with an
exact code the decoded update equals the full-batch update, and a
stochastic code is unbiased.  Matrix products run in full float32 (TF32
off), as the reference computes.

``CodedTrainer`` runs its steps through a ``train.stepper.Stepper`` (one
per trainer, built on its first run): on a card the step is captured once
into a CUDA graph, the workers' forward and backward, the combine and
AdamW in it, and every later step is one replay; ``self._step`` stays the
functional eager step, the A/B reference.

``run_coded_sgd`` adapts the trainer to the Strategy interface
(``RunResult`` with engine times as the x-axis); ``runtime.strategies``
registers it as ``coded-sgd``.  Every entry point takes ``device``: the
CUDA card unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import grad_and_value, vmap
from torch.profiler import record_function

from repro_torch.configs.base import ArchConfig
from repro_torch.core.gradient_coding import GradientCode, make_code
from repro_torch.data.pipeline import GroupBatcher, TokenStream
from repro_torch.device import full_f32_matmul, resolve_device
from repro_torch.kernels.coded_reduce import coded_combine_call
from repro_torch.models import transformer as T
from repro_torch.models.common import Dtype
from repro_torch.obs.timing import CompileWatch, block
from repro_torch.obs.trace import span as _obs_span
from repro_torch.optim import adamw_init, adamw_update, cosine_schedule
from repro_torch.runtime.engine import ClusterEngine, FastestK, _policy_k_min
from repro_torch.tree import tree_leaves, tree_unflatten

from .stepper import Stepper

__all__ = ["TrainerConfig", "TrainProblem", "build_coded_train_step",
           "CodedTrainer", "run_coded_sgd"]


@dataclasses.dataclass
class TrainerConfig:
    """Loop configuration (canonical home; ``train.trainer`` re-exports)."""
    m_workers: int = 8            # coded-DP worker shards
    beta: int = 2                 # code redundancy degree
    wait_k: int = 6               # fastest-k the master waits for
    rows_per_worker: int = 1      # sequences per data GROUP (per slot)
    seq_len: int = 128
    steps: int = 100
    lr: float = 3e-4
    warmup: int = 20
    seed: int = 0
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 0
    log_every: int = 10
    uncoded: bool = False         # baseline: no redundancy (beta=1)
    code: Optional[str] = None    # gradient code name; None -> frc/uncoded


@dataclasses.dataclass(frozen=True)
class TrainProblem:
    """The ``ProblemSpec`` analogue for ``train``-kind cells: which LM to
    train on the synthetic token stream (experiments/spec.py builds one per
    ``ProblemAxis(kind='train')``)."""
    arch: str = "deepseek-7b"
    preset: str = "smoke"         # "smoke" | "100m"
    seq_len: int = 64
    rows_per_worker: int = 1
    vocab: int = 512

    def build_cfg(self) -> ArchConfig:
        from repro_torch.configs import ARCHS
        base = ARCHS[self.arch]
        if self.preset == "100m":
            # ~100M params: 12L x 768, tied embeddings (examples/train_lm.py)
            return base.with_overrides(
                n_layers=12, d_model=768, n_heads=12, n_kv=12, d_ff=2048,
                vocab=16384, head_dim=64, dtype="float32",
                param_dtype="float32", attn_chunk=256)
        if self.preset == "smoke":
            return base.smoke_variant().with_overrides(vocab=self.vocab)
        raise ValueError(f"unknown train preset '{self.preset}' "
                         f"(have: smoke, 100m)")


def build_coded_train_step(cfg: ArchConfig, lr_fn: Callable, *,
                           rows_per_group: int, num_groups: int,
                           weight_decay: float = 0.1,
                           z_loss_weight: float = 1e-3) -> Callable:
    """(params, opt_state, tokens, labels, coeff, decode) ->
    (params, opt_state, metrics).

    tokens/labels: (m, g, S) integer tensors — worker-major coded layout
    from ``GroupBatcher``; coeff: (m, g) float32 LOCAL combine coefficients
    (B[i, group_of_row]); decode: (m,) float32 decode weights c(A_t); all on
    the parameters' device.

    The full-gradient estimate is  (1/num_groups) sum_i c_i grad_i  with
    grad_i the gradient of worker i's coefficient-weighted fixed-denominator
    CE — one forward and backward batched over the workers, and ONE
    ``coded_combine_call`` over the flattened (m, P_total) gradient block.
    Router aux losses ride along scaled by the mean local coefficient, so
    they pass through the same (unbiased) combine.  Nothing is updated in
    place: the step returns new parameters and optimizer state.
    """
    if cfg.n_patches or cfg.n_enc_layers:
        raise ValueError("coded-sgd covers token-only LMs (no patch/encoder "
                         "modalities in the coded worker layout)")

    def worker_loss(params, tokens, labels, coeff):
        # tokens/labels (g, S); coeff (g,) — one worker's shard
        logits, aux = T.forward(params, cfg, tokens)
        logp = torch.log_softmax(logits, dim=-1)
        # -log p of each label; nll_loss's backward writes each row's one
        # entry directly (no scatter)
        nll = F.nll_loss(logp.reshape(-1, logp.shape[-1]),
                         labels.reshape(-1).long(), reduction="none")
        ll = -nll.reshape(labels.shape)
        denom = float(rows_per_group * labels.shape[-1])
        ce = -(ll * coeff[:, None]).sum() / denom
        scale = coeff.mean()
        total = ce + scale * (
            cfg.router_aux_weight * aux.get("load_balance", 0.0)
            + z_loss_weight * aux.get("router_z", 0.0))
        return total, ce

    # one worker's (gradient, (total, ce)), batched over the worker axis
    per_worker = vmap(grad_and_value(worker_loss, has_aux=True),
                      in_dims=(None, 0, 0, 0))

    @full_f32_matmul
    def step(params, opt_state, tokens, labels, coeff, decode):
        leaves = tree_leaves(params)
        sizes = [p.numel() for p in leaves]
        m = tokens.shape[0]
        with record_function("coded:worker_grad"):
            grads, (_, losses_ce) = per_worker(params, tokens, labels, coeff)
        with torch.no_grad():
            with record_function("coded:flatten"):
                flat = torch.empty((m, sum(sizes)), dtype=torch.float32,
                                   device=leaves[0].device)
                off = 0
                for g, size in zip(tree_leaves(grads), sizes):
                    flat[:, off:off + size].copy_(g.reshape(m, size))
                    off += size
                del grads
            with record_function("coded:combine"):
                combined = coded_combine_call(flat, decode) / num_groups
            del flat
            out, off = [], 0
            for p, size in zip(leaves, sizes):
                out.append(combined[off:off + size].view(p.shape)
                           .to(p.dtype))
                off += size
            loss = torch.dot(decode, losses_ce) / num_groups
            lr = lr_fn(opt_state.count)
            with record_function("coded:adamw"):
                params, opt_state, om = adamw_update(
                    tree_unflatten(params, out), opt_state, params, lr=lr,
                    weight_decay=weight_decay)
        return params, opt_state, {"loss": loss, "lr": lr, **om}

    return step


class CodedTrainer:
    """Engine-driven coded training loop.

    Straggler/fault realization, active-set policy and wall-clock all come
    from one pre-sampled ``ClusterEngine`` schedule (so runs are resumable
    and reproducible per engine seed); per-step host time is split into
    the kernels' build and the step's capture and the rest via
    ``obs.timing.CompileWatch``; the realized schedule is kept as
    ``last_schedule``.  The model and the optimizer state live on
    ``device`` (unset: the CUDA card).

    The steps run through ``stepper`` (a ``Stepper``, built on the first
    run and kept for the later ones: on a card one capture a trainer, a
    replay a step).  ``run(params, opt)`` copies the caller's trees into
    its static buffers and returns clones of them, so a run leaves the
    caller's trees as they were and a later run does not change what an
    earlier one returned; checkpoints are written from the static
    buffers.
    """

    def __init__(self, cfg: ArchConfig, tcfg: TrainerConfig,
                 engine: ClusterEngine, policy=None, degrade=None, *,
                 device=None):
        self.cfg, self.tcfg = cfg, tcfg
        self.device = resolve_device(device)
        if engine.m != tcfg.m_workers:
            raise ValueError(f"engine has m={engine.m} workers but "
                             f"TrainerConfig.m_workers={tcfg.m_workers}")
        name = tcfg.code or ("uncoded" if tcfg.uncoded else "frc")
        beta = 1 if tcfg.uncoded else tcfg.beta
        self.code: GradientCode = make_code(name, tcfg.m_workers, beta=beta,
                                            seed=tcfg.seed)
        self.stream = TokenStream(cfg.vocab, seed=tcfg.seed)
        self.batcher = GroupBatcher(self.stream, self.code,
                                    tcfg.rows_per_worker, tcfg.seq_len,
                                    seed=tcfg.seed)
        self.engine = engine
        self.policy = policy if policy is not None else FastestK(tcfg.wait_k)
        if degrade is not None and degrade.mode == "hold":
            raise ValueError("coded-sgd supports renormalize/backoff degrade "
                             "only (the decode weights renormalize over the "
                             "active set by construction; see DESIGN.md §15)")
        self.degrade = degrade
        lr_fn = cosine_schedule(tcfg.lr, tcfg.warmup, tcfg.steps)
        self._step = build_coded_train_step(
            cfg, lr_fn, rows_per_group=tcfg.rows_per_worker,
            num_groups=self.code.num_groups)
        self.last_schedule = None
        self.stepper: Optional[Stepper] = None

    def init_state(self, key=None):
        """Random parameters (``key``: an int seed or a CPU
        ``torch.Generator``; default the config's seed) and a zero
        optimizer state, on the trainer's device."""
        key = key if key is not None else self.tcfg.seed
        params = T.init_params(self.cfg, key, device=self.device)
        opt = adamw_init(params, dtype=Dtype.of(self.cfg.optstate_dtype))
        return params, opt

    def run(self, params=None, opt=None, callback: Optional[Callable] = None):
        if params is None:
            params, opt = self.init_state()
        tc = self.tcfg
        sched = self.engine.sample_schedule(tc.steps, self.policy,
                                            degrade=self.degrade)
        self.last_schedule = sched
        history = []
        with _obs_span("train:coded", code=self.code.codename,
                       steps=tc.steps, m=tc.m_workers):
            for t in range(tc.steps):
                code_t = self.code.at_step(t)
                tokens, labels, coeff = self.batcher.next_batch(code_t)
                mask = np.asarray(sched.masks[t])
                batch = (tokens, labels, coeff,
                         np.asarray(code_t.decode_weights(mask), np.float32))
                if t == 0:
                    self._bind(params, opt, batch)
                with CompileWatch() as cw:
                    metrics = block(self.stepper.step(*batch))
                rec = {"step": t, "loss": float(metrics["loss"]),
                       "grad_norm": float(metrics["grad_norm"]),
                       "sim_time_s": float(sched.times[t]),
                       "active": int((mask > 0).sum()),
                       "exact": bool(code_t.decode_exact_possible(mask)),
                       "host_s": cw.total_s, "compile_s": cw.compile_s,
                       "execute_s": cw.execute_s, "compiles": cw.compiles}
                history.append(rec)
                if callback:
                    callback(rec)
                if tc.log_every and t % tc.log_every == 0:
                    print(f"step {t:5d} loss {rec['loss']:.4f} "
                          f"gnorm {rec['grad_norm']:.3f} "
                          f"active {rec['active']}/{tc.m_workers} "
                          f"simtime {rec['sim_time_s']:.1f}s", flush=True)
                if (tc.checkpoint_dir and tc.checkpoint_every
                        and (t + 1) % tc.checkpoint_every == 0):
                    from repro_torch.checkpoint import save
                    save(tc.checkpoint_dir, t + 1,
                         (self.stepper.params, self.stepper.opt))
        if tc.steps:
            params, opt = self.stepper.state()
        return params, opt, history

    def _bind(self, params, opt, batch) -> None:
        """Build the stepper on the first run (its buffers take ``batch``'s
        shapes) and copy the caller's trees into it."""
        if self.stepper is None:
            tokens = batch[0]
            self.stepper = Stepper(
                self._step, params, opt, batch,
                f"train {self.cfg.name}, m {tokens.shape[0]}, rows "
                f"{tokens.shape[1]}, sequence length {tokens.shape[2]}")
        self.stepper.load(params, opt)


def run_coded_sgd(spec: TrainProblem, engine: ClusterEngine, *,
                  steps: int = 100, device=None, **cfg):
    """Strategy-interface adapter: one coded-SGD run on ``device`` (unset:
    the CUDA card) as a ``RunResult`` whose times axis is the engine's
    simulated wall-clock.

    cfg keys: policy (ActiveSetPolicy), k (FastestK shorthand), code
    (gradient code name), beta, lr, warmup, log_every, seed, degrade
    (parsed ``DegradePolicy``), checkpoint_dir/checkpoint_every.  Unknown
    keys raise ``ValueError`` (the executor's skip path).
    """
    from repro_torch.runtime.strategies import (RunResult, _fault_meta,
                                                _resolve_degrade)

    policy = cfg.pop("policy", None)
    k = cfg.pop("k", None)
    if policy is None:
        policy = FastestK(k if k is not None else max(1, (3 * engine.m) // 4))
    degrade = _resolve_degrade(policy, cfg)
    code = cfg.pop("code", None) or "frc"
    beta = int(cfg.pop("beta", 2))
    tcfg = TrainerConfig(
        m_workers=engine.m, beta=beta, wait_k=_policy_k_min(policy),
        rows_per_worker=spec.rows_per_worker, seq_len=spec.seq_len,
        steps=steps, lr=float(cfg.pop("lr", 3e-3)),
        warmup=int(cfg.pop("warmup", min(10, max(1, steps // 5)))),
        seed=int(cfg.pop("seed", engine.seed)),
        checkpoint_dir=cfg.pop("checkpoint_dir", None),
        checkpoint_every=int(cfg.pop("checkpoint_every", 0)),
        log_every=int(cfg.pop("log_every", 0)),
        uncoded=(str(code).lower() in ("uncoded", "none")), code=str(code))
    if cfg:
        raise ValueError(f"unknown coded-sgd config keys {sorted(cfg)}")
    trainer = CodedTrainer(spec.build_cfg(), tcfg, engine, policy=policy,
                           degrade=degrade, device=device)
    _, _, hist = trainer.run()
    sched = trainer.last_schedule
    meta = {"arch": spec.arch, "preset": spec.preset,
            "code": trainer.code.codename, "beta": trainer.code.beta
            if hasattr(trainer.code, "beta") else beta,
            "policy": type(policy).__name__,
            "seq_len": spec.seq_len, "rows_per_worker": spec.rows_per_worker,
            "mean_active": float(np.mean([r["active"] for r in hist])),
            "exact_fraction": float(np.mean([r["exact"] for r in hist])),
            "host_s": float(sum(r["host_s"] for r in hist)),
            "compile_s": float(sum(r["compile_s"] for r in hist)),
            "compiles": int(sum(r["compiles"] for r in hist)),
            **_fault_meta(engine, policy, degrade, sched.masks)}
    return RunResult(
        strategy="coded-sgd",
        times=np.asarray([r["sim_time_s"] for r in hist]),
        objective=np.asarray([r["loss"] for r in hist]),
        w=None, meta=meta, schedule=sched)
