"""The port's autotune controller against the JAX package's.

The counterparts of ``tests/test_autotune.py`` on the port (knob cost
classes from ``canonical()``, the recall proxy's exact ground truth,
seeded successive halving + epsilon-greedy decisions, quarantine of
SLO-blowing probes, pre-warm-then-switch promotion with no first use on
the request path, fail-open under injected faults), on the CPU, plus the
port's decision log held equal to the reference controller's for the same
seed and measurements.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.autotune import Controller as JController
from repro.autotune import Objective as JObjective
from repro.autotune import ProbeMeasurement as JMeasurement
from repro.autotune import TuneSpace as JSpace
from repro.autotune import spec_key as j_spec_key
from repro.core.spec import SearchSpec as JSearchSpec

from repro_torch.autotune import (AutotuneDriver, Controller, Objective,
                                  ProbeMeasurement, RecallProxy, TuneSpace,
                                  spec_key)
from repro_torch.autotune.space import Knob
from repro_torch.core.index import AnnIndex
from repro_torch.core.spec import (KNOB_DOMAINS, REQUEST_ONLY_FIELDS,
                                   STRUCTURAL_FIELDS, SearchSpec,
                                   is_request_only)
from repro_torch.data.vectors import recall_at_k
from repro_torch.fault import failpoints as fault
from repro_torch.serve import ServeFrontend

BUCKETS = (1, 8, 16)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these small searches run beside other test
    processes on a shared CPU (the setting is restored afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def built(small_ds):
    return AnnIndex.build(small_ds.base, graph="hnsw", m=12, efc=64,
                          device="cpu")


# --------------------------------------------------------------------------
# space: knob domains + cost classes derived from canonical()
# --------------------------------------------------------------------------
def test_cost_classes_follow_canonical_semantics():
    """A knob is request-only exactly when perturbing it leaves the
    compiled-engine cache key unchanged — derived, not hand-listed."""
    for f in REQUEST_ONLY_FIELDS:
        assert is_request_only(f), f
    for f in ("efs", "beam_width", "engine", "estimate", "router",
              "max_hops", "beam_prune"):
        assert not is_request_only(f), f
    with pytest.raises(KeyError):
        is_request_only("not_a_field")
    space = TuneSpace(SearchSpec(), [Knob("efs", (32, 64)), Knob("k", (5, 10))])
    assert space.cost_class("efs") == "engine"
    assert space.cost_class("k") == "request"
    assert [k.name for k in space.engine_knobs] == ["efs"]
    assert [k.name for k in space.request_knobs] == ["k"]
    # every field in exactly one cost class, as in the reference
    fields = {f.name for f in dataclasses.fields(SearchSpec)}
    classes = [set(KNOB_DOMAINS), set(REQUEST_ONLY_FIELDS),
               set(STRUCTURAL_FIELDS)]
    assert set().union(*classes) == fields
    assert sum(len(c) for c in classes) == len(fields)


def test_candidate_enumeration_deterministic_and_deduped():
    base = SearchSpec(k=10, efs=32, router="crouting")
    space = TuneSpace.default(base, efs=(8, 32, 64), beam_width=(1, 2))
    cands = space.candidates()
    # efs=8 < k=10 dropped; 2 efs x 2 beam survive, in declaration order
    assert [(c.efs, c.beam_width) for c in cands] == \
        [(32, 1), (32, 2), (64, 1), (64, 2)]
    assert cands == space.candidates()       # stable across calls
    keys = [spec_key(c) for c in cands]
    assert len(set(keys)) == len(keys)
    # request-only knobs collapse onto one engine identity
    space2 = TuneSpace(base, [Knob("efs", (32, 64)),
                              Knob("cos_theta", (0.5, 0.9))])
    assert len(space2.candidates()) == 2
    # domains advertised in core.spec stay importable/enumerable
    assert set(KNOB_DOMAINS) >= {"efs", "beam_width", "estimate"}


# --------------------------------------------------------------------------
# controller: deterministic seeded search over a synthetic system
# --------------------------------------------------------------------------
def _fake_probe(spec, replays=1):
    """Synthetic system: latency ~ efs*W, recall rises with efs."""
    lat_ms = float(spec.efs * spec.beam_width)
    recall = min(1.0, 0.80 + spec.efs / 640.0)
    return ProbeMeasurement(key=spec_key(spec), recall=recall,
                            lat_s=lat_ms * 1e-3, dist_calls=float(spec.efs),
                            replays=replays)


def _make_controller(seed=0, slo_ms=200.0, mode="max_recall"):
    base = SearchSpec(k=10, efs=32, router="crouting")
    space = TuneSpace.default(base, efs=(32, 64, 128), beam_width=(1, 2))
    return Controller(space, Objective(slo_p99_ms=slo_ms, mode=mode),
                      _fake_probe, seed=seed, screen_replays=(1, 2),
                      max_finalists=4, epsilon=0.3)


def _delta(p99_ms, served=64, qps=50.0):
    return {"p99_ms": p99_ms, "served": served, "qps": qps}


def test_screen_quarantines_slo_blowing_probes_and_picks_max_recall():
    ctl = _make_controller()
    d = ctl.screen()
    assert d.kind == "screen"
    # efs=128,W=2 probes at 256ms > 200ms SLO: quarantined during probing
    assert list(ctl.quarantined) == \
        ["efs=128,W=2,router=crouting,estimate=exact,engine=fused,prune=best"]
    # incumbent = max recall among feasible candidates
    assert ctl.incumbent.startswith("efs=128,W=1")
    assert ctl.by_key[ctl.incumbent].efs == 128


def test_violation_steps_down_then_headroom_steps_back_up():
    ctl = _make_controller()
    ctl.screen()
    # live p99 blows the SLO -> calibrated model picks a cheaper feasible
    d = ctl.step(_delta(400.0))
    assert d.kind == "switch" and "SLO violated" in d.reason
    assert ctl.by_key[ctl.incumbent].efs < 128
    down = ctl.by_key[ctl.incumbent]
    # sustained deep headroom -> upgrade to a higher-recall finalist
    kinds = []
    for _ in range(6):
        kinds.append(ctl.step(_delta(20.0)).kind)
        if ctl.by_key[ctl.incumbent].efs > down.efs:
            break
    assert ctl.by_key[ctl.incumbent].efs > down.efs, kinds


def test_min_p99_mode_respects_recall_floor():
    ctl = _make_controller(mode="min_p99")
    ctl.objective = dataclasses.replace(ctl.objective, recall_floor=0.88)
    ctl.screen()
    inc = ctl.by_key[ctl.incumbent]
    assert ctl.measurements[ctl.incumbent].recall >= 0.88
    # cheapest candidate meeting the floor: efs=64 (recall 0.9), not 32
    assert inc.efs == 64 and inc.beam_width == 1


def test_decision_log_deterministic_per_seed():
    """Same observation trace + same seed -> byte-identical decision log
    (the acceptance property; epsilon exploration draws from the seeded
    PRNG only)."""
    trace = [400.0, 150.0, 20.0, 180.0, 20.0, 20.0, 350.0, 100.0, 20.0,
             190.0, 20.0, 150.0]

    def run(seed):
        ctl = _make_controller(seed=seed)
        ctl.screen()
        for p99 in trace:
            ctl.step(_delta(p99))
        return [d.to_dict() for d in ctl.decisions]

    assert run(7) == run(7)
    # the log replays the full bracket + every epoch
    log = run(7)
    assert log[0]["kind"] == "screen" and len(log) == 1 + len(trace)


def test_idle_window_is_a_noop_decision():
    ctl = _make_controller()
    ctl.screen()
    inc = ctl.incumbent
    d = ctl.step({"p99_ms": None, "served": 0})
    assert d.kind == "idle" and ctl.incumbent == inc


# --------------------------------------------------------------------------
# proxy: attach-time exact ground truth, probe replay correctness
# --------------------------------------------------------------------------
def test_proxy_synthesized_probes_hit_exact_ground_truth(built):
    proxy = RecallProxy.for_index(built, n_probe=12, k=10, seed=3,
                                  buckets=BUCKETS)
    assert proxy.queries.shape == (12, built.graph.dim)
    assert proxy.gt.shape == (12, 10)
    m = proxy.evaluate(SearchSpec(k=10, efs=64, router="crouting"),
                       replays=1)
    assert m.recall >= 0.95          # a rich spec nails near-dup probes
    assert m.lat_s > 0 and m.replays == 1


def test_proxy_explicit_queries_and_gt(built, small_ds, ground_truth):
    proxy = RecallProxy.for_index(built, queries=small_ds.queries[:10],
                                  gt=ground_truth[:10], buckets=BUCKETS)
    m = proxy.evaluate(SearchSpec(k=10, efs=64, router="crouting"))
    # matches direct search recall on the same queries
    ids, _, _ = built.search(small_ds.queries[:10],
                             spec=SearchSpec(k=10, efs=64, router="crouting"))
    assert m.recall == pytest.approx(
        recall_at_k(ids, ground_truth[:10], 10))


def test_proxy_explicit_gt_wider_than_k(built, small_ds):
    with pytest.raises(AssertionError, match="narrower"):
        RecallProxy(built, small_ds.queries[:4], np.zeros((4, 5), np.int64),
                    k=10)


# --------------------------------------------------------------------------
# driver: end-to-end attach/step/promote on a live frontend
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def tuned(built, small_ds):
    """One attached frontend+driver shared by the e2e tests (session
    warmup + screening probes are the expensive part)."""
    spec = SearchSpec(k=10, efs=32, router="crouting")
    fe = ServeFrontend(built, spec, buckets=BUCKETS)
    space = TuneSpace.default(spec, efs=(16, 32), beam_width=(1,))
    drv = AutotuneDriver.attach(fe, Objective(slo_p99_ms=60_000.0),
                                space=space, n_probe=8, seed=1)
    return fe, drv


def test_attach_screens_and_promotes_within_slo(tuned):
    fe, drv = tuned
    assert drv.controller.incumbent is not None
    assert spec_key(fe.active_spec) == drv.controller.incumbent
    assert drv.decisions[0].kind == "screen"
    # promotion pre-warmed the ladder: no first use on the request path
    assert fe.telemetry.recompiles_after_warmup == 0


def test_step_consumes_window_delta_and_keeps(tuned, small_ds):
    fe, drv = tuned
    for n in (1, 3, 8):
        fe.search(small_ds.queries[:n])
    d = drv.step()
    # absurdly loose SLO -> never a violation; keep/probe/switch-up only
    assert d.kind in ("keep", "probe", "switch")
    assert d.measured["served"] >= 3
    assert fe.telemetry.recompiles_after_warmup == 0


def test_health_surfaces_controller_state(tuned):
    fe, drv = tuned
    h = fe.health()
    assert h["autotune"]["incumbent"] == drv.controller.incumbent
    assert h["autotune"]["failures"] == drv.failures
    assert h["autotune"]["objective"]["slo_p99_ms"] == 60_000.0
    assert "last_decision" in h["autotune"]
    assert h["active_spec"]["efs"] == fe.active_spec.canonical().efs


def test_fail_open_on_injected_controller_fault(tuned, small_ds):
    """An injected controller exception leaves the
    frontend serving the last-good spec, recorded as a fail decision."""
    fe, drv = tuned
    active = fe.active_spec
    fails0, n_dec = drv.failures, len(drv.decisions)
    fault.arm("autotune.step", kind="raise")
    try:
        d = drv.step()
    finally:
        fault.disarm("autotune.step")
    assert d.kind == "fail" and "fail-open" in d.reason
    assert drv.failures == fails0 + 1 and drv.last_error is not None
    assert len(drv.decisions) == n_dec + 1
    assert fe.active_spec is active          # untouched
    ids, _, _ = fe.search(small_ds.queries[:2])   # still serving
    assert ids.shape == (2, 10)
    # and the loop recovers on the next (un-faulted) step
    d2 = drv.step()
    assert d2.kind != "fail"


def test_fail_open_on_probe_fault_during_screen(built):
    """A probe-path fault during the screening bracket fails open too:
    the frontend keeps its construction-time spec."""
    spec = SearchSpec(k=10, efs=32, router="crouting")
    fe = ServeFrontend(built, spec, buckets=(1, 8))
    space = TuneSpace.default(spec, efs=(32,), beam_width=(1,))
    fault.arm("autotune.probe", kind="raise")
    try:
        drv = AutotuneDriver.attach(fe, 60_000.0, space=space, n_probe=4,
                                    seed=0)
    finally:
        fault.disarm("autotune.probe")
    assert drv.decisions[-1].kind == "fail"
    assert fe.active_spec.efs == 32          # last-good spec still serving
    assert fe.search(np.asarray(built.graph.vectors[:2]))[0].shape == (2, 10)


# --------------------------------------------------------------------------
# the port's controller against the reference's
# --------------------------------------------------------------------------
def _j_fake_probe(spec, replays=1):
    m = _fake_probe(spec, replays)
    return JMeasurement(key=j_spec_key(spec), recall=m.recall,
                        lat_s=m.lat_s, dist_calls=m.dist_calls,
                        replays=replays)


@pytest.mark.parametrize("mode", ["max_recall", "min_p99"])
@pytest.mark.parametrize("seed", [0, 7])
def test_decision_log_equals_the_reference_controller(seed, mode):
    """The same seed and the same measurements give the reference's
    decision log, record for record (engine names mapped: the port's
    ``torch`` is the reference's ``jnp``)."""
    trace = [400.0, 150.0, 20.0, 180.0, 20.0, 20.0, 350.0, 100.0, 20.0,
             190.0, None, 20.0, 150.0]
    kw = dict(seed=seed, screen_replays=(1, 2), max_finalists=4,
              epsilon=0.3)
    floor = 0.88 if mode == "min_p99" else 0.0
    ctl = Controller(
        TuneSpace.default(SearchSpec(k=10, efs=32, router="crouting",
                                     engine="torch"),
                          efs=(32, 64, 128), beam_width=(1, 2)),
        Objective(slo_p99_ms=200.0, mode=mode, recall_floor=floor),
        _fake_probe, **kw)
    jctl = JController(
        JSpace.default(JSearchSpec(k=10, efs=32, router="crouting",
                                   engine="jnp"),
                       efs=(32, 64, 128), beam_width=(1, 2)),
        JObjective(slo_p99_ms=200.0, mode=mode, recall_floor=floor),
        _j_fake_probe, **kw)
    for c in (ctl, jctl):
        c.screen()
        for p99 in trace:
            c.step({"p99_ms": p99, "served": 0 if p99 is None else 64,
                    "qps": 50.0})
    got = [d.to_dict() for d in ctl.decisions]
    want = [d.to_dict() for d in jctl.decisions]
    assert repr(got).replace("engine=torch", "engine=jnp") == repr(want)
    assert ctl.health().keys() == jctl.health().keys()
