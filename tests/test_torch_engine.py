"""The port's Engine against the JAX package's Engine: the request
streams of tests/test_paged_engine.py and tests/test_mixed_batching.py
(page-aligned and copy-on-write reuse boundaries, staggered mixed waves,
the unfused baseline, eviction under a tiny pool) replayed through both
on the same float32 parameters. Outputs must be token-identical, the
data-plane stats equal, and the port's page pool consistent.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, reduced
from repro.core.request import Request as JRequest
from repro.models import zoo as jzoo
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import EngineConfig as JEngineConfig
from repro_torch import bridge
from repro_torch.configs import ARCHS as TARCHS
from repro_torch.configs import reduced as treduced
from repro_torch.core.request import Request as TRequest
from repro_torch.serving.engine import Engine as TEngine
from repro_torch.serving.engine import EngineConfig as TEngineConfig

torch.set_num_threads(1)

STATS = ("reused_tokens", "prefilled_tokens", "model_dispatches",
         "fused_iterations", "fused_padded_tokens", "seed_aliased_pages",
         "seed_copied_pages", "decode_batches")


@pytest.fixture(scope="module")
def small_model():
    kw = dict(n_layers=2, dtype="float32")
    jcfg = dataclasses.replace(reduced(ARCHS["smollm-360m"]), **kw)
    tcfg = dataclasses.replace(treduced(TARCHS["smollm-360m"]), **kw)
    jparams = jzoo.build(jcfg).init(jax.random.PRNGKey(0))
    tparams = bridge.tree_from_numpy(jax.tree.map(np.asarray, jparams),
                                     "cpu")
    return jcfg, jparams, tcfg, tparams


def _paged_engine_stream(shared_len, n=6, seed=1, tail=8, out=4):
    """tests/test_paged_engine.py::_mk_requests, two waves (2, then the
    rest once the first finished)."""
    rng = np.random.default_rng(seed)
    shared = tuple(rng.integers(1, 128, shared_len).tolist())
    reqs = [(shared + tuple(rng.integers(1, 128, tail).tolist()), out)
            for _ in range(n)]
    return [(0, reqs[:2]), ("after", reqs[2:])]


def _mixed_stream(seed):
    """tests/test_mixed_batching.py::test_fused_mixed_matches_dense_oracle:
    staggered waves at iterations 0 and 4 with random tails/budgets."""
    rng = np.random.default_rng(seed)
    chunk = int(rng.choice([8, 16, 24]))
    shared_len = int(rng.choice([16, 23, 32, 41]))
    shared = tuple(rng.integers(1, 128, shared_len).tolist())

    def wave(n, seed2):
        rr = np.random.default_rng(seed2)
        return [(shared + tuple(rr.integers(1, 128, int(rr.integers(4, 20)))
                                .tolist()), int(rr.integers(3, 8)))
                for _ in range(n)]
    return chunk, [(0, wave(3, seed + 10)), (4, wave(4, seed + 20))]


def _eviction_stream():
    """tests/test_paged_engine.py: unique 40-token prompts, tiny pool."""
    rng = np.random.default_rng(3)
    return [(0, [(tuple(rng.integers(1, 128, 40).tolist()), 3)
                 for _ in range(6)])]


def _drive(eng, Request, waves, max_iters=2000):
    """Enqueue each wave at its iteration ("after": once everything
    enqueued so far finished); step until all requests finished."""
    done, now, queued = [], 0.0, 0
    pending = list(waves)
    total = sum(len(rs) for _, rs in waves)
    for it in range(max_iters):
        while pending and (pending[0][0] == it or (
                pending[0][0] == "after" and len(done) == queued)):
            for toks, out in pending.pop(0)[1]:
                eng.scheduler.enqueue(Request(tokens=toks,
                                              max_new_tokens=out), now)
                queued += 1
        if len(done) == total:
            break
        done += eng.step(now)
        if isinstance(eng, TEngine):
            eng.pool.check_invariants()
        now += 0.01
    assert len(done) == total, "requests did not finish"
    return {(r.tokens, r.max_new_tokens): list(r.output_tokens)
            for r in done}


SCENARIOS = {
    "aligned32": (dict(max_context=64, chunk_size=16, max_batch_tokens=64,
                       capacity_tokens=4096, page_size=16),
                  _paged_engine_stream(32)),
    "cow29": (dict(max_context=64, chunk_size=16, max_batch_tokens=64,
                   capacity_tokens=4096, page_size=16),
              _paged_engine_stream(29, n=4)),
    "unfused29": (dict(max_context=64, chunk_size=16, max_batch_tokens=64,
                       capacity_tokens=4096, page_size=16, fused=False),
                  _paged_engine_stream(29, n=4)),
    "eviction": (dict(max_context=64, chunk_size=16, max_batch_tokens=64,
                      capacity_tokens=200, page_size=8),
                 _eviction_stream()),
}
for _seed in (0, 1, 2):
    _chunk, _waves = _mixed_stream(_seed)
    SCENARIOS[f"mixed{_seed}"] = (
        dict(max_context=96, chunk_size=_chunk, max_batch_tokens=96,
             max_batch_requests=16, capacity_tokens=8192, page_size=16),
        _waves)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_engine_matches_jax_engine(small_model, name):
    jcfg, jparams, tcfg, tparams = small_model
    econf, waves = SCENARIOS[name]
    jeng = JEngine(jcfg, jparams, JEngineConfig(paged=True, **econf))
    teng = TEngine(tcfg, tparams, TEngineConfig(paged=True, **econf),
                   device="cpu")
    jout = _drive(jeng, JRequest, waves)
    tout = _drive(teng, TRequest, waves)
    assert tout == jout
    for k in STATS:
        assert teng.stats[k] == jeng.stats[k], k
    assert teng.stats["reused_tokens"] > 0 or name == "eviction"
    if name == "cow29":
        assert teng.stats["seed_copied_pages"] > 0
    if name == "aligned32":
        assert teng.stats["seed_aliased_pages"] > 0
        assert teng.stats["seed_copied_pages"] == 0
    if name == "eviction":
        assert teng.scheduler.stats["evicted_tokens"] > 0
    teng.pool.check_invariants()
    assert teng.pages["p0"]["g0"]["k"].device.type == "cpu"


def test_engine_failover_resets_pool(small_model):
    _, _, tcfg, tparams = small_model
    eng = TEngine(tcfg, tparams, TEngineConfig(
        max_context=64, chunk_size=16, max_batch_tokens=64,
        capacity_tokens=4096, page_size=16), device="cpu")
    for _, wave in _paged_engine_stream(32, n=3):
        for toks, out in wave:
            eng.scheduler.enqueue(TRequest(tokens=toks, max_new_tokens=out),
                                  0.0)
    eng.step(0.0)
    assert len(eng.fail()) == 3
    assert eng.pool.used_pages == 1          # only the scratch page
    eng.pool.check_invariants()


def test_engine_defaults_to_the_card(small_model):
    """Without device= the engine runs on CUDA or raises; it never
    falls back to the CPU."""
    _, _, tcfg, tparams = small_model
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is satisfiable")
    with pytest.raises(RuntimeError, match="CUDA"):
        TEngine(tcfg, tparams, TEngineConfig())


@pytest.mark.parametrize("field,value", [("chips_per_instance", 2)])
def test_unported_planes_raise(small_model, field, value):
    """Once refused, a tensor-parallel engine now builds on the CPU (its
    shards emulated there); without device= it runs on the card, and
    raises on a machine with too few cards, never emulating silently."""
    _, _, tcfg, tparams = small_model
    eng = TEngine(tcfg, tparams, TEngineConfig(**{field: value}),
                  device="cpu")
    assert eng.mesh is not None and eng.mesh.size == value
    assert len(eng.params) == len(eng.pages) == value
    if torch.cuda.device_count() < value:
        with pytest.raises((RuntimeError, ValueError)):
            TEngine(tcfg, tparams, TEngineConfig(**{field: value}))


@pytest.mark.parametrize("plane", ["host_tier", "prefetch", "speculative",
                                   "dense"])
def test_ported_planes_build_on_cpu_and_default_to_the_card(small_model,
                                                            plane):
    """The host tier, its prefetch, speculation and the dense plane build
    on the CPU when asked for it; without device= they run on CUDA or
    raise, never falling back to the CPU. Prefetch without the tier, and
    tensor-parallel instances on the dense plane, are refused, as in the
    JAX package."""
    from repro_torch.serving.speculative import SpeculativeConfig
    _, _, tcfg, tparams = small_model
    kw = {"host_tier": dict(host_capacity_tokens=64),
          "prefetch": dict(host_capacity_tokens=64,
                           prefetch_budget_tokens=64),
          "speculative": dict(speculative=SpeculativeConfig(
              draft_cfg=dataclasses.replace(tcfg, n_layers=1))),
          "dense": dict(paged=False)}[plane]
    eng = TEngine(tcfg, tparams, TEngineConfig(**kw), device="cpu")
    assert (eng.draft is not None) == (plane == "speculative")
    assert (eng.host_store is not None) == (plane in ("host_tier",
                                                      "prefetch"))
    assert eng.paged == (plane != "dense")
    if plane == "dense":
        with pytest.raises(ValueError, match="paged data plane"):
            TEngine(tcfg, tparams, TEngineConfig(paged=False,
                                                 chips_per_instance=2),
                    device="cpu")
    if plane == "prefetch":
        assert eng.scheduler.prefetch_enabled
        with pytest.raises(ValueError, match="host_capacity_tokens"):
            TEngine(tcfg, tparams, TEngineConfig(prefetch_budget_tokens=64),
                    device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TEngine(tcfg, tparams, TEngineConfig(**kw))
