"""The port's tensor-parallel instances against the JAX package's SPMD
data plane: the scenarios of tests/test_spmd_engine.py and
tests/test_speculative.py::test_spec_exact_on_spmd_mesh replayed through
the port's TP engine (shards emulated on the CPU) and the JAX TP engine
on the emulated 8-device mesh (tests/conftest.py) on the same float32
parameters. Outputs and stats must be identical to the JAX TP engine's,
and outputs token-identical to the port's own single-chip oracle. Plus
PartitionSpec parity with the JAX package for every parameter and pool
leaf of the buildable configs at TP 1/2/4/8, the shard/unshard round
trip, the slot shards' valid-token count, the slot partials and their
merge against unsharded paged attention, the refusal to emulate a
submesh silently, ``bench_spmd`` and the serve CLI.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, reduced
from repro.core.cost_model import CostModel as JCostModel
from repro.core.cost_model import HardwareSpec as JHardwareSpec
from repro.core.cost_model import cost_model_for as jcost_model_for
from repro.core.global_scheduler import GlobalSchedulerConfig as JGSConfig
from repro.core.request import Request as JRequest
from repro.launch import mesh as jmesh
from repro.launch import sharding as jshard
from repro.models import zoo as jzoo
from repro.serving.cluster import ClusterRuntime as JCluster
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import EngineConfig as JEngineConfig
from repro.serving.speculative import SpeculativeConfig as JSpec
from repro_torch import bridge
from repro_torch.configs import ARCHS as TARCHS
from repro_torch.configs import reduced as treduced
from repro_torch.core.cost_model import cost_model_for
from repro_torch.core.global_scheduler import GlobalSchedulerConfig as \
    TGSConfig
from repro_torch.core.request import Request as TRequest
from repro_torch.kernels import paged_attention as PA
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import sharding as tshard
from repro_torch.models import attention as tatt
from repro_torch.models import zoo as tzoo
from repro_torch.serving.cluster import ClusterRuntime as TCluster
from repro_torch.serving.engine import Engine as TEngine
from repro_torch.serving.engine import EngineConfig as TEngineConfig
from repro_torch.serving.speculative import SpeculativeConfig as TSpec

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
ENV = {**os.environ, "PYTHONPATH": str(ROOT / "src")}

STATS = ("reused_tokens", "prefilled_tokens", "model_dispatches",
         "iterations", "fused_iterations", "fused_padded_tokens",
         "seed_aliased_pages", "seed_copied_pages", "decode_batches",
         "decode_steps")
TIER_STATS = ("demoted_tokens", "restored_tokens", "restore_failures",
              "demote_batches", "restore_dispatches", "prefetch_issued",
              "prefetch_hit", "prefetch_wasted")
SPEC_STATS = ("spec_proposed_tokens", "spec_accepted_tokens",
              "spec_rejected_tokens", "spec_verify_lanes",
              "spec_draft_dispatches", "spec_degraded")
BUILDABLE = ("smollm-360m", "internlm2-1.8b", "command-r-35b",
             "command-r-plus-104b", "llama3-70b", "mistral-7b",
             "grok-1-314b", "mixtral-8x22b")


# The JAX engines of this module jit their dispatches afresh and close
# over their own (sharded) parameters; the first engine's functions for
# a given (parameters, TP degree) are kept and handed to later ones, so
# each batch shape compiles once per TP degree.
_JIT_ATTRS = ("_decode_paged_fn", "_extend_paged_fn", "_mixed_paged_fn",
              "_mixed_spec_fn", "_copy_page_fn", "_gather_pages_fn",
              "_scatter_tokens_fn")
_JITS = {}


def _share_jits(jeng, params):
    for name in _JIT_ATTRS:
        if hasattr(jeng, name):
            key = (name, id(params), jeng.chips,
                   jeng.draft is not None and name == "_mixed_spec_fn")
            setattr(jeng, name, _JITS.setdefault(
                key, (params, jeng, getattr(jeng, name)))[2])
    return jeng


@pytest.fixture(scope="module")
def small_model():
    """tests/test_spmd_engine.py's model: reduced smollm-360m, 2 layers,
    float32 (H 2, KH 1: the pool slot-shards at TP 2 and 4)."""
    kw = dict(n_layers=2, dtype="float32")
    jcfg = dataclasses.replace(reduced(ARCHS["smollm-360m"]), **kw)
    tcfg = dataclasses.replace(treduced(TARCHS["smollm-360m"]), **kw)
    jparams = jzoo.build(jcfg).init(jax.random.PRNGKey(0))
    tparams = bridge.tree_from_numpy(jax.tree.map(np.asarray, jparams),
                                     "cpu")
    return jcfg, jparams, tcfg, tparams


def _econf(chips, device_capacity=8192, **kw):
    """Per-chip capacity_tokens at a FIXED device capacity, so the
    scheduling is the same at every TP degree."""
    base = dict(max_context=96, chunk_size=16, max_batch_tokens=96,
                max_batch_requests=16,
                capacity_tokens=device_capacity // max(chips, 1),
                page_size=16, chips_per_instance=chips)
    base.update(kw)
    return base


def _engines(small_model, chips, cfgs=None, **kw):
    jcfg, jparams, tcfg, tparams = cfgs or small_model
    ec = _econf(chips, **kw)
    jeng = _share_jits(JEngine(jcfg, jparams, JEngineConfig(**ec)), jparams)
    return jeng, TEngine(tcfg, tparams, TEngineConfig(**ec), device="cpu")


def _waves(vocab, seed, n1=3, n2=4, tail=(4, 20), new=(3, 8)):
    """tests/test_spmd_engine.py::_waves as token tuples."""
    rng = np.random.default_rng(seed)
    shared_len = int(rng.choice([16, 23, 32, 41]))
    shared = tuple(rng.integers(1, vocab, shared_len).tolist())

    def wave(n, s2):
        rr = np.random.default_rng(s2)
        return [(shared + tuple(rr.integers(1, vocab,
                                            int(rr.integers(*tail)))
                                .tolist()),
                 int(rr.integers(*new))) for _ in range(n)]

    return [(0, wave(n1, seed + 10)), (4, wave(n2, seed + 20))]


def _drive(eng, Request, waves, max_iters=2000, check=None):
    done, now = [], 0.0
    waves = [(at, [Request(tokens=t, max_new_tokens=n) for t, n in rs])
             for at, rs in waves]
    total = sum(len(rs) for _, rs in waves)
    for it in range(max_iters):
        for at, rs in waves:
            if at == it:
                for r in rs:
                    eng.scheduler.enqueue(r, now)
        before = eng.stats["model_dispatches"]
        got = eng.step(now)
        if check is not None:
            check(it, eng, eng.stats["model_dispatches"] - before, got)
        done += got
        now += 0.01
        if len(done) == total and it >= max(at for at, _ in waves):
            break
    assert len(done) == total, "requests did not finish"
    return done


def _outs(done):
    return {(tuple(r.tokens), r.max_new_tokens): list(r.output_tokens)
            for r in done}


def _same(jeng, teng, keys=STATS):
    for k in keys:
        assert teng.stats[k] == jeng.stats[k], k
    teng.pool.check_invariants()


# ---------------------------------------------------------------------
# the JAX package's SPMD scenarios
# ---------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sharded_matches_jax_and_the_oracle(small_model, seed):
    """chips 4 fused paged plane: outputs and stats identical to the JAX
    TP engine's, and token-identical to the port's single-chip dense
    oracle (tests/test_spmd_engine.py::test_sharded_matches_dense_oracle)."""
    _, _, tcfg, tparams = small_model
    waves = _waves(tcfg.vocab_size, seed)
    oracle = _outs(_drive(TEngine(tcfg, tparams,
                                  TEngineConfig(**_econf(1, paged=False)),
                                  device="cpu"), TRequest, waves))
    jeng, teng = _engines(small_model, 4)
    assert teng.mesh is not None and teng.fused
    assert teng.plan.pool == "slot" and not teng.plan.heads
    tout = _outs(_drive(teng, TRequest, waves))
    jout = _outs(_drive(jeng, JRequest, waves))
    assert tout == jout == oracle
    _same(jeng, teng)
    assert teng.stats["fused_iterations"] > 0
    assert teng.stats["reused_tokens"] > 0, "cache never hit"


def test_sharded_offload_restore_prefetch_exact(small_model):
    """A 160-token device pool, host tier and prefetch budget: evictions
    demote KV per shard, re-hits restore or prefetch it back; the 4-chip
    engine matches the JAX 4-chip engine (outputs, stats) and the port's
    1-chip engine (outputs), with the shard timers ticking only under a
    mesh."""
    jcfg, _, tcfg, _ = small_model
    rng = np.random.default_rng(7)
    shared = tuple(rng.integers(1, tcfg.vocab_size, 23).tolist())
    rr = np.random.default_rng(70)
    warm = [(shared + tuple(rr.integers(1, tcfg.vocab_size, 8).tolist()),
             3) for _ in range(3)]
    thrash = [(tuple(np.random.default_rng(700 + i)
                     .integers(1, tcfg.vocab_size, 45).tolist()), 6)
              for i in range(6)]

    def serve(eng, Request):
        def drain(done, target, now):
            for _ in range(3000):
                if len(done) >= target:
                    return now
                done += eng.step(now)
                now += 0.01
            raise RuntimeError("engine did not converge")

        done, now = [], 0.0
        for t, n in warm:
            eng.scheduler.enqueue(Request(tokens=t, max_new_tokens=n), now)
        now = drain(done, len(warm), now)
        for t, n in thrash:
            eng.scheduler.enqueue(Request(tokens=t, max_new_tokens=n), now)
        for _ in range(6):
            done += eng.step(now)
            now += 0.01
        for t, n in warm:
            eng.scheduler.enqueue(Request(tokens=t, max_new_tokens=n), now)
        drain(done, 2 * len(warm) + len(thrash), now)
        return _outs(done)

    kw = dict(device_capacity=160, max_context=64, page_size=8,
              max_batch_tokens=64, max_batch_requests=4,
              host_capacity_tokens=4096, prefetch_budget_tokens=256)
    outs, engs = {}, {}
    for chips in (1, 4):
        jeng, teng = _engines(small_model, chips, **kw)
        outs[chips] = serve(teng, TRequest)
        if chips == 4:
            assert serve(jeng, JRequest) == outs[4]
            _same(jeng, teng, STATS + TIER_STATS)
            teng.host_store.check_invariants()
        engs[chips] = teng
    e4 = engs[4]
    assert e4.stats["demoted_tokens"] > 0, "no demote traffic"
    assert e4.stats["restored_tokens"] > 0, "no restore traffic"
    assert outs[4] == outs[1]
    assert e4.stats["shard_dma_seconds"] > 0.0
    assert e4.stats["collective_seconds"] > 0.0
    assert engs[1].stats["shard_dma_seconds"] == 0.0
    assert engs[1].stats["collective_seconds"] == 0.0


def test_exactly_one_dispatch_per_step(small_model):
    """One lowered batch and one sharded dispatch per scheduling step,
    mixed or pure-decode; idle steps dispatch nothing. Outputs and stats
    as the JAX 4-chip engine's."""
    _, _, tcfg, _ = small_model
    rng = np.random.default_rng(3)
    reqs = [(tuple(rng.integers(1, tcfg.vocab_size, 20 + i).tolist()), 5)
            for i in range(5)]
    waves = [(0, reqs[:3]), (2, reqs[3:])]

    def one(it, eng, delta, done):
        assert delta == (1 if eng.depth > 0 or done else 0), \
            f"step {it}: {delta} dispatches"

    jeng, teng = _engines(small_model, 4)
    tout = _outs(_drive(teng, TRequest, waves, check=one))
    assert tout == _outs(_drive(jeng, JRequest, waves))
    assert teng.stats["model_dispatches"] == teng.stats["iterations"]
    _same(jeng, teng)


def test_pool_capacity_scales_with_chips(small_model):
    """Fixed per-chip capacity: the pooled device KV tokens (scheduler
    budget and physical pool) scale linearly with the submesh, as the
    JAX engine's do, and each shard holds a 1/tp slice of every page
    (KH 1: slot-wise)."""
    jcfg, jparams, tcfg, tparams = small_model
    pools = {}
    for chips in (1, 2, 4):
        ec = _econf(chips, device_capacity=2048 * chips)
        assert ec["capacity_tokens"] == 2048
        teng = TEngine(tcfg, tparams, TEngineConfig(**ec), device="cpu")
        jeng = JEngine(jcfg, jparams, JEngineConfig(**ec))
        assert teng.econf.device_capacity_tokens == 2048 * chips
        assert teng.scheduler.config.capacity_tokens == 2048 * chips
        assert teng.pool.num_pages == jeng.pool.num_pages
        pools[chips] = teng.pool.num_pages * ec["page_size"]
        if chips > 1:
            jleaf = jax.tree.leaves(jeng.pages)[0]
            assert tshard.pool_pspec(tuple(jleaf.shape), teng.mesh) \
                == tuple(jleaf.sharding.spec) == (None, "model", None, None)
            assert len(teng.pages) == chips
            leaf = teng.pages[0]["p0"]["g0"]["k"]
            assert leaf.shape == (teng.pool.num_pages, 16 // chips, 1, 16)
            assert leaf.shape == jleaf.addressable_shards[0].data.shape
    base = pools[1] - 2 * 16 * 16 - 16
    assert pools[2] - pools[1] == 2048
    assert pools[4] - pools[2] == 2 * 2048
    assert base == 2048


def test_gqa_head_sharding_when_divisible(small_model):
    """KH 2 at TP 2: the pool shards head-wise and the engine stays
    token-exact against the 1-chip engine and the JAX TP engine."""
    jcfg, _, tcfg, _ = small_model
    jcfg2 = dataclasses.replace(jcfg, n_heads=2, n_kv_heads=2)
    tcfg2 = dataclasses.replace(tcfg, n_heads=2, n_kv_heads=2)
    jparams2 = jzoo.build(jcfg2).init(jax.random.PRNGKey(1))
    tparams2 = bridge.tree_from_numpy(jax.tree.map(np.asarray, jparams2),
                                      "cpu")
    cfgs = (jcfg2, jparams2, tcfg2, tparams2)
    waves = _waves(tcfg2.vocab_size, 11)
    outs = {}
    for chips in (1, 2):
        jeng, teng = _engines(small_model, chips, cfgs=cfgs)
        outs[chips] = _outs(_drive(teng, TRequest, waves))
        if chips == 2:
            jleaf = jax.tree.leaves(jeng.pages)[0]
            assert tuple(jleaf.sharding.spec) == (None, None, "model", None)
            assert teng.plan.pool == "head" and teng.plan.heads
            assert teng.pages[1]["p0"]["g0"]["k"].shape[2] == 1
            assert outs[2] == _outs(_drive(jeng, JRequest, waves))
            _same(jeng, teng)
    assert outs[2] == outs[1]


def test_heterogeneous_cluster_with_migration(small_model):
    """Mesh-of-meshes: a [4, 1] cluster (disjoint submeshes, per-instance
    cost models, aggregate capacities) finishes the workload exactly as
    the 1-chip cluster and the JAX [4, 1] cluster, survives a
    drain-driven host-tier migration, and keeps every invariant."""
    jcfg, jparams, tcfg, tparams = small_model
    kw = dict(max_context=96, chunk_size=16, max_batch_tokens=96,
              max_batch_requests=8, capacity_tokens=2048, page_size=16,
              host_capacity_tokens=8192)
    rng = np.random.default_rng(5)
    shared = tuple(rng.integers(1, tcfg.vocab_size, 24).tolist())

    def reqs(Request):
        rr = np.random.default_rng(9)
        return [Request(tokens=shared
                        + tuple(rr.integers(1, tcfg.vocab_size, 8 + i)
                                .tolist()),
                        max_new_tokens=4, arrival_time=0.005 * i)
                for i in range(8)]

    def serve(cl, Request, chips):
        done = list(cl.run(reqs(Request), dt=0.01))
        cl.check_invariants()
        out = _outs(done)
        if chips is None:
            return out, None
        moved = cl.drain_instance(0, 1.0)
        more = Request(tokens=shared + (5, 6, 7), max_new_tokens=3)
        now = 1.0
        assert cl.submit(more, now) == 1
        for _ in range(200):
            cl.step(now)
            now += 0.01
            if len(cl.finished) == len(done) + 1:
                break
        assert len(cl.finished) == len(done) + 1
        cl.check_invariants()
        return out, (moved, list(more.output_tokens), dict(cl.stats))

    outs = {}
    for chips in ([4, 1], None):
        cl = TCluster(tcfg, tparams, num_instances=2, device="cpu",
                      engine_cfg=TEngineConfig(**kw),
                      chips_per_instance=chips)
        if chips is not None:
            assert cl.gs.instances[0].capacity_tokens == 4 * 2048
            assert cl.gs.instances[1].capacity_tokens == 2048
            cm0 = cl.gs.instances[0].cost_model
            cm1 = cl.gs.instances[1].cost_model
            assert cm0.prefill_a * 4 == pytest.approx(cm1.prefill_a)
            meshes = [e.mesh for e in cl.engines.values()]
            assert meshes[0] is not None and meshes[1] is None
            assert meshes[0].size == 4
        outs[repr(chips)] = serve(cl, TRequest, chips)
    jcl = JCluster(jcfg, jparams, num_instances=2,
                   engine_cfg=JEngineConfig(**kw), chips_per_instance=[4, 1])
    for i, e in jcl.engines.items():
        _share_jits(e, jparams)
    jout = serve(jcl, JRequest, [4, 1])
    assert outs["[4, 1]"][0] == outs["None"][0] == jout[0]
    assert outs["[4, 1]"][1] == jout[1]


def _rebalance_and_drain(cl, Request, vocab):
    """The stream above on a [2, 1] cluster with 48 tokens a chip, then
    8 unique 44-token prompts that push the shared prefix into instance
    0's host tier; instance 0 is flagged heavy, so E2 routes 3 re-hits
    to instance 1 with a migration of the demoted prefix
    (``_execute_migration``); then instance 0 drains (its host tier
    migrates) and one more re-hit runs on the survivor. The same stream
    as chip_smoke.py's heterogeneous cluster."""
    rng = np.random.default_rng(5)
    shared = tuple(rng.integers(1, vocab, 24).tolist())
    rr = np.random.default_rng(9)
    first = [Request(tokens=shared + tuple(rr.integers(1, vocab, 8 + i)
                                           .tolist()),
                     max_new_tokens=4, arrival_time=0.005 * i)
             for i in range(8)]
    n = len(cl.run(first, dt=0.01))
    now = 1.0

    def serve(reqs):
        nonlocal now, n
        for r in reqs:
            cl.submit(r, now)
        n += len(reqs)
        for _ in range(3000):
            cl.step(now)
            now += 0.01
            if len(cl.finished) == n:
                cl.check_invariants()
                return reqs
        raise RuntimeError("cluster did not converge")

    thrash = serve([Request(tokens=tuple(rr.integers(1, vocab, 44)
                                         .tolist()), max_new_tokens=2)
                    for _ in range(8)])
    cl.gs._redirects = {0: 1}
    again = serve([Request(tokens=shared + tuple(rr.integers(1, vocab, 6)
                                                 .tolist()),
                           max_new_tokens=3) for _ in range(3)])
    migrations = (cl.stats["migrations"], cl.stats["migrated_tokens"])
    moved = cl.drain_instance(0, now)
    more = serve([Request(tokens=shared + (5, 6, 7), max_new_tokens=3)])
    reqs = first + thrash + again + more
    return ([r.instance for r in reqs], [list(r.output_tokens)
                                         for r in reqs], migrations, moved)


def test_heterogeneous_cluster_migrates_on_rebalance_and_drain(small_model):
    """A [2, 1] cluster under pressure: E2 migrates a demoted prefix out
    of the 2-chip instance's host tier on a rebalance, and a drain
    migrates the rest; placements, outputs and migrations identical to
    the JAX [2, 1] cluster's (same H100 cost-model numbers), outputs
    token-identical to the port's 1-chip cluster."""
    jcfg, jparams, tcfg, tparams = small_model
    kw = dict(max_context=96, chunk_size=16, max_batch_tokens=96,
              max_batch_requests=8, capacity_tokens=48, page_size=16,
              host_capacity_tokens=8192)
    gs = dict(th_bal=1e9, capacity_tokens=48, host_capacity_tokens=8192)
    tcm = cost_model_for("llama3-70b")
    runs = {}
    for chips in ([2, 1], None):
        cl = TCluster(tcfg, tparams, num_instances=2, device="cpu",
                      engine_cfg=TEngineConfig(**kw), cost_model=tcm,
                      scheduler_cfg=TGSConfig(**gs),
                      chips_per_instance=chips)
        runs[repr(chips)] = _rebalance_and_drain(cl, TRequest,
                                                 tcfg.vocab_size)
    jcm = JCostModel(hw=JHardwareSpec(**dataclasses.asdict(tcm.hw)),
                     model=jcost_model_for("llama3-70b").model)
    jcl = JCluster(jcfg, jparams, num_instances=2,
                   engine_cfg=JEngineConfig(**kw), cost_model=jcm,
                   scheduler_cfg=JGSConfig(**gs), chips_per_instance=[2, 1])
    for e in jcl.engines.values():
        _share_jits(e, jparams)
    jrun = _rebalance_and_drain(jcl, JRequest, jcfg.vocab_size)
    trun = runs["[2, 1]"]
    assert trun == jrun
    assert trun[2][0] >= 1, "E2 planned no migration (vacuous test)"
    assert trun[3] > 0, "the drain migrated nothing (vacuous test)"
    assert trun[1] == runs["None"][1]


def test_spec_exact_on_spmd_mesh(small_model):
    """Speculation on a 4-chip engine (draft params and pool sharded by
    the target's policies) against the single-chip non-speculative
    baseline: token-exact, one target dispatch per iteration, outputs
    and stats as the JAX 4-chip speculative engine's."""
    jcfg, jparams, tcfg, tparams = small_model
    rng = np.random.default_rng(11)
    shared = tuple(rng.integers(1, tcfg.vocab_size, 24).tolist())

    def wave(m, s2):
        rr = np.random.default_rng(s2)
        return [(shared + tuple(rr.integers(1, tcfg.vocab_size,
                                            int(rr.integers(4, 20)))
                                .tolist()), int(rr.integers(6, 14)))
                for _ in range(m)]

    waves = [(0, wave(4, 12)), (3, wave(4, 13))]
    kw = dict(max_context=96, chunk_size=16, max_batch_tokens=128,
              max_batch_requests=16, page_size=16)
    base = _outs(_drive(TEngine(tcfg, tparams, TEngineConfig(
        capacity_tokens=8192, **kw), device="cpu"), TRequest, waves))
    teng = TEngine(tcfg, tparams, TEngineConfig(
        capacity_tokens=2048, chips_per_instance=4,
        speculative=TSpec(draft_cfg=tcfg, k=3, draft_params=tparams), **kw),
        device="cpu")
    assert teng.draft.plan is not None and len(teng.draft.params) == 4
    tout = _outs(_drive(teng, TRequest, waves))
    assert tout == base
    jeng = JEngine(jcfg, jparams, JEngineConfig(
        capacity_tokens=2048, chips_per_instance=4,
        speculative=JSpec(draft_cfg=jcfg, k=3, draft_params=jparams), **kw))
    assert _outs(_drive(jeng, JRequest, waves)) == tout
    _same(jeng, teng, STATS + SPEC_STATS)
    st = teng.stats
    assert st["spec_accepted_tokens"] > 0
    assert st["model_dispatches"] <= st["iterations"]
    assert not teng.draft.pool.tables
    teng.draft.pool.check_invariants()


# ---------------------------------------------------------------------
# PartitionSpecs, sharding, the slot arithmetic, the merge
# ---------------------------------------------------------------------

def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("tp", [1, 2, 4, 8])
@pytest.mark.parametrize("arch", BUILDABLE)
def test_partition_specs_match_jax(arch, tp):
    """serve_policy, param_pspecs, pool_pspec and span_pspec give the JAX
    package's PartitionSpec for every parameter leaf of the config at
    full width and for its pool and span leaves."""
    jcfg, tcfg = ARCHS[arch], TARCHS[arch]
    japi = jzoo.build(jcfg)
    tspecs = bridge.param_specs(tcfg)
    assert bridge.param_bytes(tcfg) == japi.n_bytes
    jm = jmesh.make_serve_mesh(tp)
    tm = tmesh.make_serve_mesh(tp, platform="cpu")
    jp = _flat(jshard.param_pspecs(
        japi.specs, jm, jshard.serve_policy(jm, japi.n_bytes)))
    tp_ = _flat(tshard.param_pspecs(
        tspecs, tm, tshard.serve_policy(tm, bridge.param_bytes(tcfg))))
    assert set(tp_) == set(jp)
    for path, spec in jp.items():
        assert tp_[path] == tuple(spec), (path, tp_[path], spec)
    ts, js = _flat(tspecs), _flat(japi.specs)
    for path, spec in js.items():
        assert ts[path].shape == spec.shape and ts[path].axes == spec.axes
    KH, D = jcfg.n_kv_heads, jcfg.head_dim
    for n_pages, ps in ((4096 // 16 + 33, 16), (12, 6), (13, 6), (64, 8)):
        for kh in (KH, 1, 5):
            shape = (n_pages, ps, kh, D)
            assert tshard.pool_pspec(shape, tm) \
                == tuple(jshard.pool_pspec(shape, jm)), shape
            for span in ((7, kh, D), (3, ps, kh, D)):
                assert tshard.span_pspec(span, tm) \
                    == tuple(jshard.span_pspec(span, jm)), span


@pytest.mark.parametrize("heads,kv_heads,tp", [(2, 1, 2), (2, 1, 4),
                                               (2, 2, 2), (8, 4, 4)])
def test_shard_params_round_trip(small_model, heads, kv_heads, tp):
    """shard_params cuts each leaf along its "model" dims into tp fresh
    pieces on the shards' devices; unshard_params puts them back."""
    _, _, tcfg, _ = small_model
    cfg = dataclasses.replace(tcfg, n_heads=heads, n_kv_heads=kv_heads)
    params = tzoo.build(cfg).init(torch.Generator().manual_seed(3), "cpu")
    mesh = tmesh.make_serve_mesh(tp, platform="cpu")
    pol = tshard.serve_policy(mesh, bridge.param_bytes(cfg))
    specs = bridge.param_specs(cfg)
    shards = tshard.shard_params(params, specs, mesh, pol)
    pspecs = _flat(tshard.param_pspecs(specs, mesh, pol))
    full = _flat(params)
    for s, tree in enumerate(shards):
        for path, piece in _flat(tree).items():
            want = list(full[path].shape)
            for d, e in enumerate(pspecs[path]):
                if e == "model":
                    want[d] //= tp
            assert list(piece.shape) == want, path
            assert piece.data_ptr() != full[path].data_ptr()
    back = _flat(tshard.unshard_params(shards, specs, mesh, pol))
    for path, t in full.items():
        assert torch.equal(back[path], t), path
    plan = tzoo.build(cfg).shard_plan(mesh, 64, 16)
    assert plan.heads == (heads % tp == 0)
    assert plan.kv_heads == (kv_heads % tp == 0) == (plan.pool == "head")
    assert tshard.tree_bytes(shards[0]) * tp >= tshard.tree_bytes(params)


@pytest.mark.parametrize("ps,tp", [(16, 2), (16, 4), (8, 4), (8, 8)])
def test_slot_lens_match_a_brute_force_count(ps, tp):
    """slot_lens gives each slot shard the number of a lane's valid
    tokens it holds, and they are the first ones of its local order
    (pages of ps/tp slots), empty shards included."""
    sl = ps // tp
    lens = torch.arange(0, 4 * ps + 1, dtype=torch.int32)
    for s in range(tp):
        got = tatt.slot_lens(lens, s, ps, sl)
        for n, g in zip(lens.tolist(), got.tolist()):
            mine = [t for t in range(n) if (t % ps) // sl == s]
            local = [(t // ps) * sl + t % ps % sl for t in mine]
            assert g == len(mine), (n, s)
            assert local == list(range(g)), (n, s)
    assert tatt.slot_lens(torch.tensor([1], dtype=torch.int32), 1, ps,
                          sl).item() == 0


@pytest.mark.parametrize("tp,n_splits", [(2, 1), (4, 1), (4, 3)])
def test_slot_partials_and_merge_match_unsharded_attention(tp, n_splits):
    """Each slot shard's partials (the plain version, at n_splits splits)
    concatenated along the split axis and merged by lse_merge_partials
    give the unsharded plain paged attention, for lanes whose shards are
    partly or wholly empty."""
    g = torch.Generator().manual_seed(5)
    B, H, KH, D, PS, P, N = 5, 6, 3, 16, 16, 6, 40
    q = torch.randn(B, H, D, generator=g)
    kp = torch.randn(N, PS, KH, D, generator=g)
    vp = torch.randn(N, PS, KH, D, generator=g)
    pt = torch.randint(1, N, (B, P), generator=g, dtype=torch.int32)
    lens = torch.tensor([1, 3, 16, 37, 96], dtype=torch.int32)
    ref = PA.paged_decode_attention_plain(q, kp, vp, pt, lens)
    sl = PS // tp
    pps = -(-P // n_splits)
    parts = []
    for s in range(tp):
        ls = tatt.slot_lens(lens, s, PS, sl)
        parts.append(PA.paged_decode_partials_plain(
            q, kp[:, s * sl:(s + 1) * sl].contiguous(),
            vp[:, s * sl:(s + 1) * sl].contiguous(), pt, ls,
            -(-P // pps), pps))
        if s:
            assert torch.isinf(parts[-1][1][0]).all(), "len 1: shard empty"
    acc, m, l = (torch.cat([p[i] for p in parts], dim=2) for i in range(3))
    got = PA.lse_merge_partials(acc, m, l, q.dtype)
    torch.testing.assert_close(got, ref, atol=2e-6, rtol=2e-5)
    whole = PA.paged_decode_partials(q, kp, vp, pt, lens)
    torch.testing.assert_close(
        PA.lse_merge_partials(*whole, q.dtype), ref, atol=2e-6, rtol=2e-5)


def test_tp_engine_never_emulates_silently(small_model):
    """Without device="cpu" or a device list, a 2-chip engine needs two
    cards: it raises on a machine with fewer (here: none); on the CPU it
    builds its shards."""
    _, _, tcfg, tparams = small_model
    ec = TEngineConfig(chips_per_instance=2)
    if torch.cuda.device_count() >= 2:
        assert TEngine(tcfg, tparams, ec).mesh.devices == (
            torch.device("cuda", 0), torch.device("cuda", 1))
    else:
        with pytest.raises((RuntimeError, ValueError)):
            TEngine(tcfg, tparams, ec)
        with pytest.raises(ValueError, match="2 devices"):
            tmesh.make_serve_mesh(2, platform="cuda")
        with pytest.raises(ValueError, match="devices"):
            tmesh.partition_devices([2, 1], platform="cuda")
    eng = TEngine(tcfg, tparams, ec, device="cpu")
    assert eng.mesh.devices == (torch.device("cpu"),) * 2


def test_bench_spmd_pool_tokens_on_cpu():
    """python -m repro_torch.launch.bench_spmd reproduces the reference's
    device pool tokens (2576 / 4624 / 8720 at TP 1 / 2 / 4) and its
    gates."""
    from repro_torch.launch import bench_spmd
    rows, _ = bench_spmd.run(device="cpu")
    assert [r["device_pool_tokens"] for r in rows] == [2576, 4624, 8720]
    assert all(r["dispatches_per_iter"] == 1.0 for r in rows)
    assert rows[0]["shard_dma_s"] == 0.0 and rows[1]["shard_dma_s"] > 0.0


def test_serve_cli_with_a_tensor_parallel_instance_on_cpu():
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--reduced",
         "--device", "cpu", "--instances", "2", "--requests", "8",
         "--max-context", "64", "--chips-per-instance", "2,1"],
        capture_output=True, text=True, env=ENV, cwd=ROOT, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "finished=8/8" in r.stdout
    assert "chips=[2, 1]" in r.stdout
