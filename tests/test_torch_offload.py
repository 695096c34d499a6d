"""The port's host KV tier against the JAX package's: the engine
scenarios of tests/test_kv_offload.py (randomized demote/restore
pressure, batched restores, restore failures with and without injected
faults, admission under exhaustion, cluster failover) and of
tests/test_prefetch.py (randomized speculative restore, prefetch
overlap, the migration target's prefetch), plus a graceful
``drain_instance`` migration, replayed through both packages on the
same float32 parameters. Outputs must be token-identical, the tier's
stats equal, and the host stores must hold the same spans, their KV
within rtol 1e-4 and an atol of max(1e-5, 1e-5 x the leaf's largest
|value|) — float32 summation order only, scaled as the pool tolerance of
tests/test_torch_model.py is, and ten ulps of float32 wider than it,
since the KV of a second layer carries the first layer's rounding. A unit case holds
bfloat16 spans bit-exact through a demote/drain/restore round trip.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, reduced
from repro.core.cost_model import HardwareSpec as JHardwareSpec
from repro.core.request import Request as JRequest
from repro.models import zoo as jzoo
from repro.serving.cluster import ClusterRuntime as JCluster
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import EngineConfig as JEngineConfig
from repro.serving.faults import FaultConfig as JFaultConfig
from repro.serving.faults import FaultInjector as JFaultInjector
from repro_torch import bridge
from repro_torch.configs import ARCHS as TARCHS
from repro_torch.configs import reduced as treduced
from repro_torch.core.cost_model import CostModel, HardwareSpec, \
    cost_model_for
from repro_torch.core.request import Request as TRequest
from repro_torch.serving.cluster import ClusterRuntime as TCluster
from repro_torch.serving.engine import Engine as TEngine
from repro_torch.serving.engine import EngineConfig as TEngineConfig
from repro_torch.serving.faults import FaultConfig as TFaultConfig
from repro_torch.serving.faults import FaultInjector as TFaultInjector
from repro_torch.serving.kv_offload import tree_leaves

torch.set_num_threads(1)

STATS = ("reused_tokens", "prefilled_tokens", "model_dispatches",
         "demoted_tokens", "restored_tokens", "restore_failures",
         "demote_batches", "demote_batches_overlapped", "restore_dispatches",
         "prefetch_issued", "prefetch_hit", "prefetch_wasted")


# Every JAX engine of this module serves one model, and its jitted
# functions depend on nothing but that model and its parameters (the
# pool and the batch are arguments). Each engine jits them afresh, which
# would recompile every batch shape per engine; so the first engine's
# functions are kept, keyed by the parameters they close over, and
# later engines reuse them.
_JIT_ATTRS = ("_decode_paged_fn", "_extend_paged_fn", "_mixed_paged_fn",
              "_mixed_spec_fn", "_copy_page_fn", "_gather_pages_fn",
              "_scatter_tokens_fn")
_JITS = {}


def _share_jits(jeng):
    """Give a JAX engine (and its draft plane) the module's compiled
    functions for its parameters; returns the engine."""
    planes = [(jeng, _JIT_ATTRS)]
    if getattr(jeng, "draft", None) is not None:
        planes.append((jeng.draft, ("_propose_fn",)))
    for obj, names in planes:
        for name in names:
            if hasattr(obj, name):
                key = (name, id(obj.params), getattr(obj, "k", None))
                # the entry holds the parameters, so their id stays theirs
                setattr(obj, name, _JITS.setdefault(
                    key, (obj.params, getattr(obj, name)))[1])
    return jeng


@pytest.fixture(scope="module")
def small_model():
    kw = dict(n_layers=2, dtype="float32")
    jcfg = dataclasses.replace(reduced(ARCHS["smollm-360m"]), **kw)
    tcfg = dataclasses.replace(treduced(TARCHS["smollm-360m"]), **kw)
    jparams = jzoo.build(jcfg).init(jax.random.PRNGKey(0))
    tparams = bridge.tree_from_numpy(jax.tree.map(np.asarray, jparams),
                                     "cpu")
    return jcfg, jparams, tcfg, tparams


def _econf(**kw):
    """tests/test_kv_offload.py::_econf (tests/test_prefetch.py's sets
    max_batch_tokens=16)."""
    base = dict(max_context=64, chunk_size=16, max_batch_tokens=64,
                capacity_tokens=160, page_size=8, paged=True,
                host_capacity_tokens=4096)
    base.update(kw)
    return base


def _engines(small_model, **kw):
    jcfg, jparams, tcfg, tparams = small_model
    econf = _econf(**kw)
    return (_share_jits(JEngine(jcfg, jparams, JEngineConfig(**econf))),
            TEngine(tcfg, tparams, TEngineConfig(**econf), device="cpu"))


def _drain(eng, target, done, now, max_iters=3000):
    for _ in range(max_iters):
        if len(done) >= target:
            return now
        done += eng.step(now)
        now += 0.01
    raise RuntimeError("engine did not converge")


def _outs(done):
    return {(tuple(r.tokens), r.max_new_tokens): list(r.output_tokens)
            for r in done}


def _same_store(jstore, tstore):
    assert set(tstore.entries) == set(jstore.entries)
    for key, je in jstore.entries.items():
        te = tstore.entries[key]
        assert (te.start, te.length) == (je.start, je.length), key
        jl, tl = tree_leaves(je.kv), tree_leaves(te.kv)
        assert [p for p, _ in tl] == [p for p, _ in jl]
        for (_, a), (_, b) in zip(jl, tl):
            a = np.asarray(a)
            np.testing.assert_allclose(
                b, a, atol=max(1e-5, 1e-5 * float(np.abs(a).max())),
                rtol=1e-4)


def _same_engines(jeng, teng):
    for k in STATS:
        assert teng.stats[k] == jeng.stats[k], k
    teng.pool.check_invariants()
    if teng.host_store is not None:
        teng.host_store.check_invariants()
        _same_store(jeng.host_store, teng.host_store)
        assert teng.scheduler.host_used_tokens \
            == teng.host_store.used_tokens
        assert set(teng.scheduler._host_lru) == set(teng.host_store.entries)


# ---------------------------------------------------------------------------
# tests/test_kv_offload.py
# ---------------------------------------------------------------------------

def _pressure_schedule(vocab, eng, Request, shared, seed):
    """tests/test_kv_offload.py::_pressure_schedule: warm the shared
    prefix, thrash it out of the device pool with unique prompts,
    re-hit it (restore), three times."""
    rng = np.random.default_rng(seed)
    now, done, n_target = 0.0, [], 0
    for wave in range(3):
        r2 = np.random.default_rng(seed + 10 * wave)
        tail, out = int(rng.integers(5, 10)), int(rng.integers(2, 4))
        hits = [Request(tokens=tuple(shared)
                        + tuple(r2.integers(1, vocab, tail).tolist()),
                        max_new_tokens=out) for _ in range(2 + wave % 2)]
        for r in hits:
            eng.scheduler.enqueue(r, now)
        n_target += len(hits)
        now = _drain(eng, n_target, done, now)
        for i in range(4):
            plen = int(rng.integers(35, 50))
            r = Request(tokens=tuple(
                np.random.default_rng(1000 * seed + 10 * wave + i)
                .integers(1, vocab, plen).tolist()),
                max_new_tokens=2)
            eng.scheduler.enqueue(r, now)
            n_target += 1
            now = _drain(eng, n_target, done, now)
    return done


def _run_pressure(small_model, shared_len, seed, **kw):
    vocab = small_model[0].vocab_size
    shared = tuple(np.random.default_rng(seed)
                   .integers(1, vocab, shared_len).tolist())
    jeng, teng = _engines(small_model, **kw)
    jout = _outs(_pressure_schedule(vocab, jeng, JRequest, shared, seed))
    tout = _outs(_pressure_schedule(vocab, teng, TRequest, shared, seed))
    return jeng, teng, jout, tout


@pytest.mark.parametrize("shared_len,seed", [(32, 1), (29, 2), (32, 3)])
def test_offload_matches_jax_engine(small_model, shared_len, seed):
    """Demote/restore under randomized pressure, CoW (unaligned) reuse
    boundaries included: token-identical, same tier stats and store."""
    jeng, teng, jout, tout = _run_pressure(small_model, shared_len, seed)
    assert tout == jout
    assert teng.stats["demoted_tokens"] > 0, "pressure never demoted"
    assert teng.stats["restored_tokens"] > 0, "re-hits never restored"
    _same_engines(jeng, teng)


def test_restore_is_batched_not_per_token(small_model):
    jeng, teng, jout, tout = _run_pressure(small_model, 32, 5)
    assert tout == jout
    _same_engines(jeng, teng)
    st = teng.stats
    assert st["restored_tokens"] > 0
    assert st["restore_dispatches"] <= st["iterations"]
    assert st["restored_tokens"] >= 8 * st["restore_dispatches"]


def _lose_planned_entries(eng):
    """Every planned host entry dies between restore planning and
    staging (tests/test_kv_offload.py's sabotage)."""
    orig = eng._host_restore_chain

    def chain_then_lose(m, boundary, limit):
        plan, end = orig(m, boundary, limit)
        for key, _, _, _ in plan:
            eng.scheduler.drop_host(key)
        return plan, end

    eng._host_restore_chain = chain_then_lose


@pytest.mark.parametrize("how", ["sabotage", "faults"])
def test_restore_failure_falls_back_to_recompute(small_model, how):
    """Planned restores that fail — entries lost mid-flight, or every
    injected host-to-device copy failing until the circuit breaker
    opens — degrade to recompute with the same tokens as the JAX
    engine."""
    vocab = small_model[0].vocab_size
    shared = tuple(np.random.default_rng(7)
                   .integers(1, vocab, 32).tolist())
    jeng, teng = _engines(small_model)
    if how == "sabotage":
        _lose_planned_entries(jeng)
        _lose_planned_entries(teng)
    else:
        jeng.attach_faults(JFaultInjector(
            JFaultConfig(dma_rates={"restore": 1.0})))
        teng.attach_faults(TFaultInjector(
            TFaultConfig(dma_rates={"restore": 1.0})))
    jout = _outs(_pressure_schedule(vocab, jeng, JRequest, shared, 7))
    tout = _outs(_pressure_schedule(vocab, teng, TRequest, shared, 7))
    assert tout == jout
    _same_engines(jeng, teng)
    assert teng.stats["restore_failures"] > 0
    assert teng.stats["restored_tokens"] == 0
    if how == "faults":
        assert teng._cb.trips == jeng._cb.trips >= 1


def test_oversized_abort_and_exhaustion_with_tier(small_model):
    vocab = small_model[0].vocab_size
    jeng, teng = _engines(small_model, capacity_tokens=200,
                          host_capacity_tokens=300)
    outs = []
    for eng, Request in ((jeng, JRequest), (teng, TRequest)):
        big = Request(tokens=tuple(range(1, 70)), max_new_tokens=8)
        eng.scheduler.enqueue(big, 0.0)
        rng = np.random.default_rng(3)
        reqs = [Request(tokens=tuple(rng.integers(1, vocab, 40).tolist()),
                        max_new_tokens=3) for _ in range(6)]
        for r in reqs:
            eng.scheduler.enqueue(r, 0.0)
        now, done = 0.0, []
        for _ in range(800):
            done += eng.step(now)
            if eng is teng:
                teng.pool.check_invariants()
                teng.host_store.check_invariants()
                assert (teng.scheduler.host_used_tokens
                        == teng.host_store.used_tokens <= 300)
            now += 0.01
            if len(done) == len(reqs) + 1:
                break
        assert big.state.value == "failed"
        assert len(done) == len(reqs) + 1, "requests starved"
        outs.append(_outs(done))
    assert outs[1] == outs[0]
    _same_engines(jeng, teng)
    assert teng.stats["aborted"] == 1
    assert teng.scheduler.stats["demoted_tokens"] > 0


def _cost_model():
    """The JAX package's cost-model numbers, so E2 prices alike."""
    return CostModel(hw=HardwareSpec(**dataclasses.asdict(JHardwareSpec())),
                     model=cost_model_for("smollm-360m").model)


def _clusters(small_model, n=2, **kw):
    jcfg, jparams, tcfg, tparams = small_model
    econf = _econf(**kw)
    jcl = JCluster(jcfg, jparams, num_instances=n,
                   engine_cfg=JEngineConfig(**econf))
    for jeng in jcl.engines.values():
        _share_jits(jeng)
    return (jcl,
            TCluster(tcfg, tparams, num_instances=n,
                     engine_cfg=TEngineConfig(**econf),
                     cost_model=_cost_model(), device="cpu"))


def _same_clusters(jcl, tcl):
    for k in ("migrations", "migrated_tokens", "drain_migrated_tokens"):
        assert tcl.stats[k] == jcl.stats[k], k
    for i, teng in tcl.engines.items():
        if not teng.failed:
            _same_engines(jcl.engines[i], teng)


def _failover_run(cl, Request, vocab):
    """tests/test_kv_offload.py::test_cluster_invariants_and_failover_
    with_tier: E2 placement + pressure + an instance failure, the
    invariants checked at every step."""
    rng = np.random.default_rng(11)
    shared = tuple(rng.integers(1, vocab, 24).tolist())
    reqs = []
    for i in range(10):
        if i % 2 == 0:
            toks = shared + tuple(rng.integers(1, vocab, 8).tolist())
        else:
            toks = tuple(rng.integers(1, vocab, 40).tolist())
        reqs.append(Request(tokens=toks, max_new_tokens=2,
                            arrival_time=0.05 * i))
    now, i, failed_once = 0.0, 0, False
    for _ in range(1500):
        while i < len(reqs) and reqs[i].arrival_time <= now:
            cl.submit(reqs[i], now)
            i += 1
        cl.step(now)
        cl.check_invariants()
        if not failed_once and len(cl.finished) >= 4:
            cl.fail_instance(0, now)
            failed_once = True
        now += 0.01
        if len(cl.finished) == len(reqs):
            break
    assert len(cl.finished) == len(reqs)
    return [(r.instance, list(r.output_tokens)) for r in reqs]


def test_cluster_invariants_and_failover_with_tier(small_model):
    vocab = small_model[0].vocab_size
    jcl, tcl = _clusters(small_model, capacity_tokens=220,
                         host_capacity_tokens=2048)
    assert _failover_run(tcl, TRequest, vocab) \
        == _failover_run(jcl, JRequest, vocab)
    _same_clusters(jcl, tcl)
    assert any(s["demoted_tokens"] > 0 for s in tcl.engine_stats().values())


def _drain_run(cl, Request, vocab):
    """Serve two prefix families, thrash them host-side, drain the
    busier instance (its host tier migrates to the survivor), then
    re-hit both families on the survivor."""
    rng = np.random.default_rng(4)
    fams = [tuple(rng.integers(1, vocab, 32).tolist()) for _ in range(2)]
    now, n = 0.0, 0

    def serve(reqs, now):
        for r in reqs:
            cl.submit(r, now)
        for _ in range(2000):
            if len(cl.finished) == n:
                return now
            cl.step(now)
            now += 0.01
        raise RuntimeError("cluster did not converge")

    first = [Request(tokens=f + tuple(rng.integers(1, vocab, 6).tolist()),
                     max_new_tokens=2) for f in fams for _ in range(2)]
    n += len(first)
    now = serve(first, now)
    thrash = [Request(tokens=tuple(rng.integers(1, vocab, 44).tolist()),
                      max_new_tokens=2) for _ in range(6)]
    n += len(thrash)
    now = serve(thrash, now)
    cl.check_invariants()
    src = max(cl.engines,
              key=lambda i: cl.engines[i].scheduler.host_used_tokens)
    moved = cl.drain_instance(src, now)
    cl.check_invariants()
    again = [Request(tokens=f + tuple(rng.integers(1, vocab, 6).tolist()),
                     max_new_tokens=2) for f in fams]
    n += len(again)
    now = serve(again, now)
    cl.check_invariants()
    return moved, [(r.instance, list(r.output_tokens))
                   for r in first + thrash + again]


def test_drain_instance_migrates_host_tier(small_model):
    vocab = small_model[0].vocab_size
    jcl, tcl = _clusters(small_model, capacity_tokens=160,
                         host_capacity_tokens=2048)
    tres = _drain_run(tcl, TRequest, vocab)
    assert tres == _drain_run(jcl, JRequest, vocab)
    assert tres[0] > 0, "the drain migrated nothing (vacuous test)"
    _same_clusters(jcl, tcl)


# ---------------------------------------------------------------------------
# tests/test_prefetch.py
# ---------------------------------------------------------------------------

def _prefetch_schedule(vocab, eng, Request, shared, seed):
    """tests/test_prefetch.py::_prefetch_schedule with its injections:
    thrash the shared prefixes host-side, re-hit them BEHIND busy
    uniques (the prefetch window), with randomized aborts, mid-wave host
    drops and divergent prompts that split chains mid-flight."""
    rng = np.random.default_rng(seed)
    now, done, n_target = 0.0, [], 0

    def put(r):
        eng.scheduler.enqueue(r, now)

    for s in shared:
        put(Request(tokens=s + tuple(rng.integers(1, vocab, 5).tolist()),
                    max_new_tokens=3))
        n_target += 1
    now = _drain(eng, n_target, done, now)
    for wave in range(3):
        for i in range(3):
            put(Request(tokens=tuple(
                np.random.default_rng(999 * seed + 31 * wave + i)
                .integers(1, vocab, int(rng.integers(38, 50))).tolist()),
                max_new_tokens=2))
            n_target += 1
        now = _drain(eng, n_target, done, now)
        put(Request(tokens=tuple(rng.integers(1, vocab, 45).tolist()),
                    max_new_tokens=2))
        n_target += 1
        done += eng.step(now)
        now += 0.01
        hits = []
        for s in shared:
            r = Request(tokens=s + tuple(rng.integers(1, vocab, 4).tolist()),
                        max_new_tokens=3)
            put(r)
            hits.append(r)
            n_target += 1
        if rng.random() < 0.7:
            cut = int(rng.integers(5, max(len(shared[0]) - 5, 6)))
            put(Request(tokens=shared[0][:cut] + tuple(
                rng.integers(1, vocab, 6).tolist()), max_new_tokens=2))
            n_target += 1
        do_abort = rng.random() < 0.5
        do_drop = rng.random() < 0.5
        drop_pick = int(rng.integers(0, 1 << 30))
        if do_abort and hits:
            victim = hits.pop()
            eng.scheduler.abort(victim)
            victim.aborted_by_test = True
            n_target -= 1
        if eng.scheduler._host_lru and do_drop:
            keys = list(eng.scheduler._host_lru)
            eng.scheduler.drop_host(keys[drop_pick % len(keys)])
        now = _drain(eng, n_target, done, now)
    return {tuple(r.tokens): list(r.output_tokens) for r in done
            if not getattr(r, "aborted_by_test", False) and r.output_tokens}


@pytest.mark.parametrize("seed", [0, 1])
def test_prefetch_matches_jax_engine_randomized(small_model, seed):
    vocab = small_model[0].vocab_size
    rng = np.random.default_rng(100 + seed)
    shared = [tuple(rng.integers(1, vocab, int(rng.integers(30, 42)))
                    .tolist()) for _ in range(2)]
    jeng, teng = _engines(small_model, max_batch_tokens=16,
                          prefetch_budget_tokens=128)
    jout = _prefetch_schedule(vocab, jeng, JRequest, shared, seed)
    tout = _prefetch_schedule(vocab, teng, TRequest, shared, seed)
    assert tout == jout
    _same_engines(jeng, teng)
    assert teng.stats["prefetch_issued"] > 0, "schedule never prefetched"
    assert teng.scheduler.prefetch_reserved_tokens == 0
    assert not teng._prefetch_inflight
    assert not [k for k in teng.pool.tables
                if isinstance(k, tuple) and k[0] == "pf"]


def _overlap_run(vocab, eng, Request):
    rng = np.random.default_rng(0)
    shared = tuple(rng.integers(1, vocab, 40).tolist())
    done, now = [], 0.0
    put = eng.scheduler.enqueue
    put(Request(tokens=shared + tuple(rng.integers(1, vocab, 6).tolist()),
                max_new_tokens=3), now)
    now = _drain(eng, 1, done, now)
    for i in range(4):
        put(Request(tokens=tuple(rng.integers(1, vocab, 45).tolist()),
                    max_new_tokens=2), now)
        now = _drain(eng, 2 + i, done, now)
    put(Request(tokens=tuple(rng.integers(1, vocab, 45).tolist()),
                max_new_tokens=2), now)
    done += eng.step(now)
    now += 0.01
    hit = Request(tokens=shared + tuple(rng.integers(1, vocab, 5).tolist()),
                  max_new_tokens=3)
    put(hit, now)
    _drain(eng, 7, done, now)
    return hit, _outs(done)


def test_engine_prefetch_overlaps_and_skips_restore(small_model):
    """A queued hit's chain is scattered by the prefetch path (issued
    before, drained after a model dispatch) and its admission aliases
    the prefetched pages: zero admission-time restores."""
    vocab = small_model[0].vocab_size
    jeng, teng = _engines(small_model, max_batch_tokens=16,
                          prefetch_budget_tokens=64)
    jhit, jout = _overlap_run(vocab, jeng, JRequest)
    thit, tout = _overlap_run(vocab, teng, TRequest)
    assert tout == jout
    _same_engines(jeng, teng)
    st = teng.stats
    assert st["prefetch_issued"] > 0 and st["prefetch_dispatches"] >= 1
    assert st["prefetch_overlap_frac"] == jeng.stats["prefetch_overlap_frac"]
    assert st["prefetch_overlap_frac"] > 0
    assert thit.prefetched_len == jhit.prefetched_len > 0
    assert thit.restored_len == 0 and st["restore_dispatches"] == 0
    assert st["prefetch_hit"] == thit.prefetched_len


def _migration_run(vocab, src, dst, Request):
    rng = np.random.default_rng(7)
    shared = tuple(rng.integers(1, vocab, 40).tolist())
    tail = tuple(rng.integers(1, vocab, 5).tolist())
    done, now = [], 0.0
    src.scheduler.enqueue(Request(tokens=shared + (5,), max_new_tokens=3),
                          now)
    now = _drain(src, 1, done, now)
    plan = src.scheduler.tree.plan_eviction(0, src.scheduler.used_tokens + 1)
    src.scheduler.apply_eviction(plan, now)
    toks = shared + (5,)
    spans = src.scheduler.export_host_span(toks, 0, len(toks))
    assert spans, "source had nothing to export"
    accepted = dst.scheduler.ingest_host_span(toks, spans, now)
    assert accepted and accepted[0][1] >= len(shared)
    dst.scheduler.enqueue(Request(tokens=tuple(
        rng.integers(1, vocab, 45).tolist()), max_new_tokens=2), now)
    dst.step(now)
    hit = Request(tokens=shared + tail, max_new_tokens=3)
    dst.scheduler.enqueue(hit, now)
    _drain(dst, 2, [], now + 0.01)
    return hit, accepted


def test_migration_target_prefetches_inbound_span(small_model):
    """A span migrated into an instance's host tier is prefetched by
    that instance's queue like any local chain."""
    vocab = small_model[0].vocab_size
    runs = []
    for pkg in (0, 1):
        engs = [_engines(small_model, instance_id=i, max_batch_tokens=16,
                         prefetch_budget_tokens=64)[pkg] for i in (0, 1)]
        hit, accepted = _migration_run(vocab, *engs,
                                       (JRequest, TRequest)[pkg])
        runs.append((engs, hit, accepted))
    (jsrc, jdst), jhit, jacc = runs[0]
    (tsrc, tdst), thit, tacc = runs[1]
    assert tacc == jacc
    assert list(thit.output_tokens) == list(jhit.output_tokens)
    assert thit.prefetched_len == jhit.prefetched_len > 0
    assert thit.restored_len == 0
    assert tdst.stats["prefetch_issued"] > 0
    _same_engines(jsrc, tsrc)
    _same_engines(jdst, tdst)


# ---------------------------------------------------------------------------
# bfloat16 bytes
# ---------------------------------------------------------------------------

def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def test_bf16_spans_round_trip_bit_exact(small_model):
    """A bfloat16 engine's prompt KV, demoted through the scheduler's
    eviction and drained into the store (as uint16 bit views), holds the
    pool's bits exactly; scattered back into fresh pages it reads back
    bit for bit."""
    tcfg, tparams = small_model[2], small_model[3]
    cfg = dataclasses.replace(tcfg, dtype="bfloat16")
    params = jax.tree.map(lambda a: a.to(torch.bfloat16), tparams)
    eng = TEngine(cfg, params, TEngineConfig(**_econf()), device="cpu")
    r = TRequest(tokens=tuple(np.random.default_rng(1)
                              .integers(1, cfg.vocab_size, 40).tolist()),
                 max_new_tokens=2)
    eng.scheduler.enqueue(r, 0.0)
    _drain(eng, 1, [], 0.0)
    sch, pool, ps = eng.scheduler, eng.pool, eng.pool.page_size
    spans = []
    for node in sch.tree.match(r.tokens).path:
        t = pool.tables[("node", node.path_key)]
        end = node.depth_tokens()
        start = end - len(node.tokens)
        spans.append((node.path_key, start, end, [
            _bits(a[t.pages].reshape(-1, *a.shape[2:])[start:end]).clone()
            for a in eng._leaves]))
    sch.apply_eviction(sch.tree.plan_eviction(0, sch.used_tokens + 1), 1.0)
    eng._drain_demotes()
    assert eng.stats["demoted_tokens"] == sum(e - s for _, s, e, _ in spans)
    eng.host_store.check_invariants()
    pool.create(("req", -1))
    pool.append(("req", -1), spans[-1][2])
    dst = pool.tables[("req", -1)]
    for key, start, end, want in spans:
        entry = eng.host_store.get(key)
        assert (entry.start, entry.length) == (start, end - start)
        got = [x for _, x in tree_leaves(entry.kv)]
        assert all(g.dtype == np.uint16 for g in got)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.view(np.int16), w.numpy())
        pidx, sidx = eng._token_page_slots(dst, ps, start, end)
        eng._scatter_staged([(pidx, sidx, entry.kv)])
        for a, w in zip(eng._leaves, want):
            back = a[dst.pages].reshape(-1, *a.shape[2:])[start:end]
            assert back.dtype == torch.bfloat16
            assert torch.equal(_bits(back), w)
