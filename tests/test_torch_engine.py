"""The port's host simulation — delay models, active-set policies, the
cluster engine, fault injection and the trace recorder — against the JAX
package, bit for bit: the port copies this numpy code, so every mask,
time, fault code and event must be identical for the same seed."""
import numpy as np
import pytest

import repro.core.straggler as jstr
import repro.obs.trace as jtrace
import repro.runtime.engine as jeng
import repro.runtime.faults as jfaults
import repro_torch.core.straggler as tstr
import repro_torch.obs.trace as ttrace
import repro_torch.runtime.engine as teng
import repro_torch.runtime.faults as tfaults

M = 8

POLICIES = {
    "fastest-k": dict(k=5),
    "adaptive-k": dict(beta=2.0, k_min=3),
    "deadline": dict(deadline=0.6, k_min=2),
    "adversarial": dict(k=5),
}


def _pair(delay: str, *, m=M, seed=0, faults=None):
    return (jeng.ClusterEngine(jeng.make_delay_model(delay), m, seed=seed,
                               faults=faults),
            teng.ClusterEngine(teng.make_delay_model(delay), m, seed=seed,
                               faults=faults))


def _same_schedule(a, b):
    assert a.m == b.m
    assert np.array_equal(a.masks, b.masks) and a.masks.dtype == b.masks.dtype
    assert np.array_equal(a.times, b.times)
    if a.failed is None:
        assert b.failed is None
    else:
        assert np.array_equal(a.failed, b.failed)
    assert [vars(e) for e in a.fault_events] == \
        [vars(e) for e in b.fault_events]
    assert len(a.events) == len(b.events)
    for ea, eb in zip(a.events, b.events):
        assert (ea.t, ea.start, ea.commit) == (eb.t, eb.start, eb.commit)
        assert np.array_equal(ea.active, eb.active)
        assert np.array_equal(ea.arrivals, eb.arrivals)


@pytest.mark.parametrize("delay", sorted(jeng.DELAY_MODELS))
@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_schedule_bitwise(delay, policy):
    je, te = _pair(delay, seed=3)
    _same_schedule(je.sample_schedule(25, jeng.make_policy(
                       policy, **POLICIES[policy])),
                   te.sample_schedule(25, teng.make_policy(
                       policy, **POLICIES[policy])))


@pytest.mark.parametrize("faults", ["preset:ec2-tail", "preset:zone-outage",
                                    "preset:flaky-rack",
                                    "crash:p=0.3,at=0.2;corrupt:p=0.1"])
@pytest.mark.parametrize("degrade", [None, "backoff:base=0.1,retries=3"])
def test_faulted_schedule_bitwise(faults, degrade):
    je, te = _pair("bimodal", seed=1, faults=faults)
    _same_schedule(
        je.sample_schedule(40, jeng.FastestK(5),
                           degrade=jfaults.make_degrade(degrade)),
        te.sample_schedule(40, teng.FastestK(5),
                           degrade=tfaults.make_degrade(degrade)))


@pytest.mark.parametrize("faults", [None, "preset:ec2-tail"])
def test_schedule_batch_and_trials_bitwise(faults):
    je, te = _pair("power_law", seed=7, faults=faults)
    jb = je.sample_schedules(12, jeng.FastestK(6), 4)
    tb = te.sample_schedules(12, teng.FastestK(6), 4)
    assert np.array_equal(jb.masks, tb.masks)
    assert np.array_equal(jb.times, tb.times)
    if faults is None:
        assert jb.failed is None and tb.failed is None
    else:
        assert np.array_equal(jb.failed, tb.failed)
    for r in range(4):
        _same_schedule(jb.realization(r), tb.realization(r))
        _same_schedule(tb.realization(r),
                       te.trial(r).sample_schedule(12, teng.FastestK(6)))
        assert te.trial(r).seed == je.trial(r).seed


def test_vectorised_fastest_k_matches_generic_loop():
    _, te = _pair("bimodal", seed=5)
    rng_a, rng_b = (np.random.default_rng(11) for _ in range(2))
    _same_schedule(te._sample_fastest_k(rng_a, 30, 5),
                   te._sample_generic(rng_b, 30, teng.FastestK(5)))


@pytest.mark.parametrize("faults", [None, "crash:p=0.2,at=1.0;corrupt:p=0.1"])
def test_async_trace_bitwise(faults):
    je, te = _pair("exponential", seed=2, faults=faults)
    ja, ta = je.sample_async(60, 4), te.sample_async(60, 4)
    for f in ("workers", "staleness", "read_versions", "times"):
        assert np.array_equal(getattr(ja, f), getattr(ta, f))
    assert (ja.dropped, ja.corrupted) == (ta.dropped, ta.corrupted)
    jb, tb = je.sample_asyncs(30, 4, 3), te.sample_asyncs(30, 4, 3)
    assert np.array_equal(jb.workers, tb.workers)
    assert np.array_equal(jb.times, tb.times)


def test_fault_spec_parsing_identical():
    for spec in ("preset:ec2-tail;crash:p=0.1,at=0.8",
                 "zone:workers=0-2+5,at=0.8,dur=1.5", "corrupt:p=0.05"):
        assert repr(tfaults.make_fault_model(spec)) == \
            repr(jfaults.make_fault_model(spec))
    for spec in ("hold", "hold:shrink=0.25,k_min=4", "backoff:base=0.1",
                 None, "renormalize"):
        assert repr(tfaults.make_degrade(spec)) == \
            repr(jfaults.make_degrade(spec))


def test_straggler_helpers_identical():
    rng_j, rng_t = np.random.default_rng(0), np.random.default_rng(0)
    for name in ("bimodal_delays", "power_law_delays", "exponential_delays",
                 "multimodal_delays", "constant_delays"):
        assert np.array_equal(getattr(jstr, name)()(rng_j, 16),
                              getattr(tstr, name)()(rng_t, 16))
    d = np.random.default_rng(1).random(10)
    for k in (0, 3, 10, 12):
        assert np.array_equal(jstr.fastest_k(d, k), tstr.fastest_k(d, k))
    assert [a.tolist() for a in jstr.adversarial_sets(8, 5, 4)] == \
        [a.tolist() for a in tstr.adversarial_sets(8, 5, 4)]
    assert [(t, A.tolist(), e) for t, A, e in
            jstr.simulate_run(jstr.bimodal_delays(), 8, 5, 6, seed=2)] == \
        [(t, A.tolist(), e) for t, A, e in
         tstr.simulate_run(tstr.bimodal_delays(), 8, 5, 6, seed=2)]


def test_trace_recorder_events_identical():
    je, te = _pair("bimodal", seed=4, faults="preset:flaky-rack")
    jr, tr = jtrace.TraceRecorder(), ttrace.TraceRecorder()
    with jr.activate():
        je.sample_schedules(6, jeng.FastestK(5), 2)
        je.sample_async(20, 3)
    with tr.activate():
        te.sample_schedules(6, teng.FastestK(5), 2)
        te.sample_async(20, 3)

    def sim(rec):
        return [e.to_dict() for e in rec.events() if e.kind != "span"]

    assert sim(tr) == sim(jr)
    assert [e.name for e in tr.spans()] == [e.name for e in jr.spans()]


def test_clamp_async_event_matches_reference():
    from repro.obs.metrics import clamp_async_event as ref
    for args in [(5, 2, 3, 10), (5, 7, 0, 10), (3, -1, 4, 10), (2, 1, 12, 5)]:
        assert ttrace.clamp_async_event(*args) == ref(*args)
