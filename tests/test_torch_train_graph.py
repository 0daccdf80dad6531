"""Training as one device program, on the CPU: the coded train step
through ``repro_torch.train.stepper.Stepper`` (on a card captured once
into a CUDA graph and replayed a step; here the same body runs eagerly
over the same static buffers) and ``CodedTrainer.run`` on top of it.

  * a ``Stepper`` over 5 steps equals a loop of ``build_coded_train_step``
    bit for bit (parameters, AdamW m, v and count, loss, lr and
    grad_norm) at every token-only architecture's smoke variant (seq 16,
    FRC over 8 workers);
  * ``CodedTrainer.run`` matches the reference's ``CodedTrainer.run``
    (``repro.train.coded``, its step under ``jax.jit``) from the same
    parameters (``params_from_numpy``) over 5 steps: losses to rel 1e-5
    of the largest (float32 sums in another order; the default config's
    warm-up keeps AdamW's steps small), under the FRC, cyclic and
    stochastic codes at deepseek-7b, phi3.5-moe and xlstm-350m, each at
    its smoke variant's width cut to one period of layers (the
    reference's compile of each case is most of this file's time);
  * on a stand-in card (``test_torch_decode_graph``'s: CPU tensors taken
    for a card's, a "capture" that reruns the step at each replay with a
    stand-in capture in force): step 0 runs eagerly, step 1 captures and
    every step from it is one replay, bit for bit the same run under
    ``graphs.capturing(False)``; one capture serves two runs of a trainer
    and a new trainer captures anew; after ``graphs.clear()`` the next
    step captures anew with no second warm-up, and under
    ``capturing(False)`` nothing is captured; a capture that fails raises,
    naming the architecture, m, the rows and the sequence length; a run
    leaves the caller's trees as they were and what it returned does not
    change in a later run; a checkpoint written mid-run, restored into a
    new trainer's stepper and stepped through the remaining batches,
    equals the uninterrupted run bit for bit.
"""
import contextlib

import jax
import numpy as np
import pytest
import torch

import repro.models.transformer as JT
import repro.optim as JO
import repro.runtime as JR
import repro.train.coded as JC
import repro_torch.train.coded as PC
from repro_torch import graphs
from repro_torch.checkpoint import restore
from repro_torch.core import make_code
from repro_torch.data import GroupBatcher, TokenStream
from repro_torch.models import init_params, params_from_numpy, \
    state_from_numpy
from repro_torch.models.common import Dtype
from repro_torch.optim import adamw_init, cosine_schedule
from repro_torch.runtime import ClusterEngine, FastestK, make_delay_model
from repro_torch.train.stepper import Stepper
from repro_torch.tree import tree_leaves, tree_map
from test_torch_decode_graph import (_FailingGraph, _equal, one_thread,
                                     stand_in_card)

M, S, STEPS = 8, 16, 5
ARCHS = ["dbrx-132b", "deepseek-7b", "gemma2-27b", "jamba-1.5-large-398b",
         "phi3.5-moe-42b-a6.6b", "stablelm-12b", "starcoder2-3b",
         "xlstm-350m"]

assert one_thread and stand_in_card        # fixtures, used by name


def _cfg(arch="deepseek-7b"):
    return PC.TrainProblem(arch=arch, seq_len=S).build_cfg()


# -- the stepper against the functional step ----------------------------------

def _batches(cfg, code, n, seed=0):
    """``n`` (tokens, labels, coeff, decode) batches, each with its own
    partial mask."""
    batcher = GroupBatcher(TokenStream(cfg.vocab, seed=seed), code, 1, S,
                           seed=seed)
    rng = np.random.default_rng(seed)
    out = []
    for t in range(n):
        mask = (rng.random(M) < 0.7).astype(np.float64)
        out.append((*batcher.next_batch(code.at_step(t)), np.asarray(
            code.at_step(t).decode_weights(mask), np.float32)))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_stepper_equals_the_step_loop(arch):
    cfg = _cfg(arch)
    code = make_code("frc", M, beta=2)
    step = PC.build_coded_train_step(cfg, cosine_schedule(1e-3, 2, 10),
                                     rows_per_group=1,
                                     num_groups=code.num_groups)
    params = init_params(cfg, 0, device="cpu")
    opt = adamw_init(params, dtype=Dtype.of(cfg.optstate_dtype))
    batches = _batches(cfg, code, STEPS)
    p, o, want = params, opt, []
    for b in batches:
        p, o, met = step(p, o, *map(torch.from_numpy, b))
        want.append(met)
    st = Stepper(step, params, opt, batches[0], f"train {arch}")
    st.load(params, opt)
    for b, met in zip(batches, want):
        got = st.step(*b)
        for k in ("loss", "lr", "grad_norm"):
            _equal(got[k], met[k])
    _equal((st.params, st.opt), (p, o))
    assert int(st.opt.count) == STEPS and st.captures == 0


def test_stepper_refuses_other_layouts():
    cfg = _cfg()
    code = make_code("frc", M, beta=2)
    step = PC.build_coded_train_step(cfg, cosine_schedule(1e-3, 2, 10),
                                     rows_per_group=1,
                                     num_groups=code.num_groups)
    params = init_params(cfg, 0, device="cpu")
    opt = adamw_init(params)
    b = _batches(cfg, code, 1)[0]
    st = Stepper(step, params, opt, b, "train deepseek-7b")
    with pytest.raises(ValueError, match="train deepseek-7b: the param"):
        st.load(init_params(cfg.with_overrides(d_model=64), 0,
                            device="cpu"), opt)
    with pytest.raises(ValueError, match="train deepseek-7b: an input"):
        st.step(b[0][:, :, :8], *b[1:])


# -- the trainer against the reference's --------------------------------------

@pytest.mark.parametrize("code", ["frc", "cyclic", "stochastic"])
@pytest.mark.parametrize("arch", ["deepseek-7b", "phi3.5-moe-42b-a6.6b",
                                  "xlstm-350m"])
def test_trainer_run_matches_reference(arch, code):
    """Both trainers at their default lr and warm-up from the reference's
    parameters, on the same engine schedule: losses rel 1e-5, and the
    simulated times and active counts equal."""
    pcfg = PC.TrainProblem(arch=arch, seq_len=S, vocab=64).build_cfg()
    pcfg = pcfg.with_overrides(n_layers=len(pcfg.period))
    jcfg = JC.TrainProblem(arch=arch, seq_len=S, vocab=64).build_cfg()
    jcfg = jcfg.with_overrides(n_layers=len(jcfg.period))
    kw = dict(m_workers=M, seq_len=S, steps=STEPS, log_every=0, code=code)
    jtr = JC.CodedTrainer(jcfg, JC.TrainerConfig(**kw), JR.ClusterEngine(
        JR.make_delay_model("bimodal"), M, seed=3), policy=JR.FastestK(6))
    ptr = PC.CodedTrainer(pcfg, PC.TrainerConfig(**kw), ClusterEngine(
        make_delay_model("bimodal"), M, seed=3), policy=FastestK(6),
        device="cpu")
    jp = JT.init_params(jcfg, jax.random.key(0))
    jo = JO.adamw_init(jp)
    pp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    po = state_from_numpy(jax.tree.map(np.asarray, jo), "cpu")
    _, _, jh = jtr.run(jp, jo)
    _, _, ph = ptr.run(pp, po)
    jl = np.asarray([h["loss"] for h in jh])
    pl = np.asarray([h["loss"] for h in ph])
    assert np.all(np.isfinite(pl))
    assert np.max(np.abs(pl - jl)) <= 1e-5 * np.max(np.abs(jl))
    for key in ("sim_time_s", "active", "exact"):
        assert [h[key] for h in ph] == [h[key] for h in jh]


# -- the trainer on a stand-in card -------------------------------------------

def _trainer(steps=STEPS, **kw):
    tcfg = PC.TrainerConfig(m_workers=M, seq_len=S, steps=steps, lr=3e-3,
                            warmup=2, log_every=0, **kw)
    return PC.CodedTrainer(_cfg(), tcfg, ClusterEngine(
        make_delay_model("bimodal"), M, seed=0), policy=FastestK(6),
        device="cpu")


def _eager_run(runs=1, **kw):
    """``runs`` runs of one trainer under ``capturing(False)``, each from
    the last one's state -> [(params, opt, history)]."""
    tr, out = _trainer(**kw), []
    params, opt = tr.init_state()
    with graphs.capturing(False):
        for _ in range(runs):
            params, opt, hist = tr.run(params, opt)
            out.append((params, opt, hist))
    assert tr.stepper.captures == 0
    return out


def _same_run(got, want):
    (gp, go, gh), (wp, wo, wh) = got, want
    _equal((gp, go), (wp, wo))
    for key in ("loss", "grad_norm", "sim_time_s", "active"):
        assert [h[key] for h in gh] == [h[key] for h in wh]


WHERE = f"train deepseek-7b, m {M}, rows 1, sequence length {S}"


def test_trainer_captures_once_and_equals_eager(stand_in_card):
    """Step 0 is the warm-up, step 1 captures, and every step from step 1
    is one replay; parameters, m, v, count, losses and grad norms equal
    the eager run's bit for bit."""
    want = _eager_run()[0]
    assert stand_in_card.wheres == []
    tr = _trainer()
    replays = []
    got = tr.run(callback=lambda rec: replays.append(
        stand_in_card.replays))
    assert replays == [0, 1, 2, 3, 4]
    assert stand_in_card.wheres == [WHERE]
    assert stand_in_card.spans == ["train:capture"]
    assert tr.stepper.captures == 1
    _same_run(got, want)
    assert int(got[1].count) == STEPS


def test_one_capture_serves_two_runs(stand_in_card):
    """A trainer's second run replays its first run's graph; a new trainer
    captures anew."""
    want = _eager_run(runs=2)
    tr = _trainer()
    params, opt = tr.init_state()
    first = tr.run(params, opt)
    second = tr.run(first[0], first[1])
    assert tr.stepper.captures == 1 and len(stand_in_card.wheres) == 1
    assert stand_in_card.replays == 2 * STEPS - 1
    _same_run(first, want[0])
    _same_run(second, want[1])
    _trainer().run()
    assert stand_in_card.wheres == [WHERE, WHERE]


def test_clear_and_capturing_off(stand_in_card):
    """After ``graphs.clear()`` the next step captures anew with no second
    warm-up; under ``capturing(False)`` the stepper runs eagerly and
    captures nothing, and the next run replays from its first step."""
    want = _eager_run(runs=4, steps=3)
    tr = _trainer(steps=3)
    params, opt = tr.init_state()
    first = tr.run(params, opt)
    assert tr.stepper.captures == 1 and stand_in_card.replays == 2
    graphs.clear()
    assert tr.stepper._graph is None
    second = tr.run(first[0], first[1])
    assert tr.stepper.captures == 2 and stand_in_card.replays == 5
    with graphs.capturing(False):
        third = tr.run(second[0], second[1])
    assert tr.stepper.captures == 2 and stand_in_card.replays == 5
    fourth = tr.run(third[0], third[1])      # still warm: replays only
    assert tr.stepper.captures == 2 and stand_in_card.replays == 8
    for got, w in zip((first, second, third, fourth), want):
        _same_run(got, w)


def test_a_failed_train_capture_raises_naming_the_trainer(monkeypatch):
    """No eager fallback: step 1 (the capture) raises with the
    architecture, m, the rows and the sequence length."""
    graphs.clear()
    monkeypatch.setattr(graphs, "_on_card", lambda t: True)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FailingGraph)
    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: device)
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    seen = []
    with pytest.raises(RuntimeError,
                       match=f"{WHERE}: capturing .*not permitted"):
        _trainer().run(callback=seen.append)
    assert [rec["step"] for rec in seen] == [0]
    graphs.clear()


def test_runs_leave_the_callers_trees_and_keep_their_returns(stand_in_card):
    tr = _trainer(steps=3)
    params, opt = tr.init_state()
    kept = tree_map(lambda t: t.clone(), (params, opt))
    p1, o1, _ = tr.run(params, opt)
    _equal((params, opt), kept)
    held = tree_map(lambda t: t.clone(), (p1, o1))
    stepper_leaves = {t.data_ptr() for t in tree_leaves(
        (tr.stepper.params, tr.stepper.opt))}
    assert not stepper_leaves & {t.data_ptr() for t in tree_leaves(
        (p1, o1))}
    p2, o2, _ = tr.run(p1, o1)
    _equal((p1, o1), held)
    # the schedule's lr is 0 past its 3 steps: the moments still move
    assert int(o2.count) == 6 and not torch.equal(o2.m["embed"],
                                                  o1.m["embed"])


def test_resume_from_a_checkpoint_equals_the_uninterrupted_run(
        stand_in_card, tmp_path, monkeypatch):
    """A run of 4 steps writes checkpoints after steps 2 and 4 from the
    stepper's buffers; step 2's, restored into a new trainer's stepper and
    stepped through the run's batches 2 and 3 (step 0 of the new stepper
    its warm-up, step 1 its capture), ends bit for bit where the run
    ended, with the same losses and grad norms."""
    batches = []
    step = Stepper.step

    def recording(self, *batch):
        batches.append(batch)
        return step(self, *batch)

    monkeypatch.setattr(Stepper, "step", recording)
    tr = _trainer(steps=4, checkpoint_dir=str(tmp_path),
                  checkpoint_every=2)
    params, opt, hist = tr.run()
    _equal(restore(str(tmp_path), 4, (params, opt)), (params, opt))
    p2, o2 = restore(str(tmp_path), 2, (params, opt))
    assert int(o2.count) == 2
    fresh = _trainer(steps=4)
    st = Stepper(fresh._step, p2, o2, batches[2], WHERE)
    st.load(p2, o2)
    for batch, rec in zip(batches[2:], hist[2:]):
        met = st.step(*batch)
        assert float(met["loss"]) == rec["loss"]
        assert float(met["grad_norm"]) == rec["grad_norm"]
    assert st.captures == 1
    _equal((st.params, st.opt), (params, opt))
