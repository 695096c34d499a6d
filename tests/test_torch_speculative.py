"""The port's draft-model speculative decoding against the JAX
package's: the scenarios of tests/test_speculative.py (a random draft,
a perfect draft, speculation under host-tier demote/restore/prefetch
thrash, short-headroom lanes, a squeezed draft pool) replayed through
both packages on the same float32 parameters — the draft's included,
bridged from the JAX package's draw. Outputs must be token-identical to
the JAX engine's and every ``spec_*`` stat equal, with one target
dispatch per iteration and no draft table left behind. Plus the plane
checks: an unpageable draft and a non-fused plane are refused. (The
SPMD case waits for tensor-parallel instances.)
"""

import dataclasses
import functools
import types

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, reduced
from repro.core.request import Request as JRequest
from repro.models import zoo as jzoo
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import EngineConfig as JEngineConfig
from repro.serving.speculative import SpeculativeConfig as JSpec
from repro_torch import bridge
from repro_torch.configs import ARCHS as TARCHS
from repro_torch.configs import reduced as treduced
from repro_torch.core.request import Request as TRequest
from repro_torch.serving.engine import Engine as TEngine
from repro_torch.serving.engine import EngineConfig as TEngineConfig
from repro_torch.serving.speculative import DraftWorker
from repro_torch.serving.speculative import SpeculativeConfig as TSpec

torch.set_num_threads(1)

SPEC_STATS = ("spec_proposed_tokens", "spec_accepted_tokens",
              "spec_rejected_tokens", "spec_verify_lanes",
              "spec_draft_dispatches", "spec_degraded")
STATS = SPEC_STATS + ("model_dispatches", "iterations", "decode_steps",
                      "prefilled_tokens", "reused_tokens")


def _to_torch(jparams):
    return bridge.tree_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")


# Every JAX engine of this module serves one target model, and its jitted
# functions depend on nothing but that model and its parameters (the
# pool and the batch are arguments). Each engine jits them afresh, which
# would recompile every batch shape per engine; so the first engine's
# functions are kept, keyed by the parameters they close over, and later
# engines reuse them. The draft's propose call reads only the draft's
# model, K and parameters; it is jitted once per (draft config, K) with
# the parameters as an argument, so drafts drawn from different seeds
# share its compiles too.
_JIT_ATTRS = ("_decode_paged_fn", "_extend_paged_fn", "_mixed_paged_fn",
              "_mixed_spec_fn", "_copy_page_fn", "_gather_pages_fn",
              "_scatter_tokens_fn")
_JITS = {}


def _share_jits(jeng):
    """Give a JAX engine and its draft plane the module's compiled
    functions; returns the engine."""
    for name in _JIT_ATTRS:
        if hasattr(jeng, name):
            # the entry holds the parameters, so their id stays theirs
            setattr(jeng, name, _JITS.setdefault(
                (name, id(jeng.params)),
                (jeng.params, getattr(jeng, name)))[1])
    d = jeng.draft
    if d is not None:
        key = ("_propose_fn", d.cfg, d.k)
        if key not in _JITS:
            def propose(params, pages, *arrays, d=d):
                view = types.SimpleNamespace(api=d.api, k=d.k, params=params)
                return type(d)._propose_impl(view, pages, *arrays)
            _JITS[key] = jax.jit(propose, donate_argnums=(1,))
        d._propose_fn = functools.partial(_JITS[key], d.params)
    return jeng

@pytest.fixture(scope="module")
def small_model():
    kw = dict(n_layers=2, dtype="float32")
    jcfg = dataclasses.replace(reduced(ARCHS["smollm-360m"]), **kw)
    tcfg = dataclasses.replace(treduced(TARCHS["smollm-360m"]), **kw)
    jparams = jzoo.build(jcfg).init(jax.random.PRNGKey(0))
    return jcfg, jparams, tcfg, _to_torch(jparams)


def _specs(small_model, perfect, k=3, seed=7):
    """Draft configs for both packages (tests/test_speculative.py::_spec):
    ``perfect`` drafts with the target itself (acceptance 1.0), else a
    random 1-layer draft — the JAX package draws it from
    PRNGKey(seed), and the port gets the same values bridged."""
    jcfg, jparams, tcfg, tparams = small_model
    if perfect:
        return (JSpec(draft_cfg=jcfg, k=k, draft_params=jparams),
                TSpec(draft_cfg=tcfg, k=k, draft_params=tparams))
    jd = dataclasses.replace(jcfg, n_layers=1)
    td = dataclasses.replace(tcfg, n_layers=1)
    dparams = jzoo.build(jd).init(jax.random.PRNGKey(seed))
    return (JSpec(draft_cfg=jd, k=k, draft_seed=seed),
            TSpec(draft_cfg=td, k=k, draft_params=_to_torch(dparams)))


def _econf(**kw):
    base = dict(max_context=96, chunk_size=16, max_batch_tokens=128,
                max_batch_requests=16, capacity_tokens=8192, page_size=16)
    base.update(kw)
    return base


def _engines(small_model, specs, **kw):
    jcfg, jparams, tcfg, tparams = small_model
    return (_share_jits(JEngine(jcfg, jparams, JEngineConfig(
                speculative=specs[0], **_econf(**kw)))),
            TEngine(tcfg, tparams,
                    TEngineConfig(speculative=specs[1], **_econf(**kw)),
                    device="cpu"))


def _waves(vocab, Request, seed, n=4, max_new=(6, 14)):
    """tests/test_speculative.py::_waves: two staggered waves over one
    shared 24-token prefix."""
    rng = np.random.default_rng(seed)
    shared = tuple(rng.integers(1, vocab, 24).tolist())

    def wave(m, s2):
        rr = np.random.default_rng(s2)
        return [Request(tokens=shared + tuple(
                    rr.integers(1, vocab, int(rr.integers(4, 20))).tolist()),
                    max_new_tokens=int(rr.integers(*max_new)))
                for _ in range(m)]

    return [(0, wave(n, seed + 1)), (3, wave(n, seed + 2))]


def _drive(eng, waves, max_iters=2000):
    done, now = [], 0.0
    total = sum(len(rs) for _, rs in waves)
    last = max(at for at, _ in waves)
    for it in range(max_iters):
        for at, rs in waves:
            if at == it:
                for r in rs:
                    eng.scheduler.enqueue(r, now)
        done += eng.step(now)
        now += 0.01
        if len(done) == total and it >= last:
            break
    assert len(done) == total, "requests did not finish"
    return {(tuple(r.tokens), r.max_new_tokens): list(r.output_tokens)
            for r in done}


def _same(jeng, teng):
    for k in STATS:
        assert teng.stats[k] == jeng.stats[k], k
    assert teng.stats["model_dispatches"] <= teng.stats["iterations"], \
        "verify lanes must ride the one fused target dispatch"
    assert not teng.draft.pool.tables, (
        f"leaked draft tables: {list(teng.draft.pool.tables)}")
    teng.draft.pool.check_invariants()
    teng.pool.check_invariants()


def _run(small_model, specs, waves_of, **kw):
    vocab = small_model[0].vocab_size
    jeng, teng = _engines(small_model, specs, **kw)
    jout = _drive(jeng, waves_of(vocab, JRequest))
    tout = _drive(teng, waves_of(vocab, TRequest))
    assert tout == jout
    _same(jeng, teng)
    return teng


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_spec_with_random_draft_matches_jax(small_model, seed):
    """A random draft proposes near-garbage; greedy verification
    rejects it and the tokens are the JAX engine's."""
    teng = _run(small_model, _specs(small_model, False, seed=seed + 7),
                lambda v, R: _waves(v, R, seed))
    st = teng.stats
    assert st["spec_verify_lanes"] > 0 and st["spec_draft_dispatches"] > 0
    assert (st["spec_accepted_tokens"] + st["spec_rejected_tokens"]
            == st["spec_proposed_tokens"] > 0)


def test_spec_with_perfect_draft_accepts_everything(small_model):
    teng = _run(small_model, _specs(small_model, True, k=4),
                lambda v, R: _waves(v, R, 3, max_new=(10, 16)))
    st = teng.stats
    assert st["spec_proposed_tokens"] > 0
    assert st["spec_rejected_tokens"] == 0
    assert st["spec_acceptance_frac"] == 1.0


def _pressure_waves(vocab, Request, eng, seed=5):
    """tests/test_speculative.py::_pressure: warm a shared prefix,
    thrash it out of the tiny device pool, re-hit it, three times."""
    shared = tuple(np.random.default_rng(seed)
                   .integers(1, vocab, 32).tolist())
    rng = np.random.default_rng(seed)
    now, done, target = 0.0, [], 0

    def drain(now):
        for _ in range(2000):
            if len(done) >= target:
                return now
            done.extend(eng.step(now))
            now += 0.01
        raise AssertionError("thrash schedule did not drain")

    for wave in range(3):
        rr = np.random.default_rng(seed + 10 * wave)
        for _ in range(2 + wave % 2):
            eng.scheduler.enqueue(Request(
                tokens=shared + tuple(rr.integers(
                    1, vocab, int(rr.integers(5, 10))).tolist()),
                max_new_tokens=int(rr.integers(3, 6))), now)
            target += 1
        now = drain(now)
        for i in range(4):
            eng.scheduler.enqueue(Request(
                tokens=tuple(np.random.default_rng(1000 * seed + 10 * wave
                                                   + i)
                             .integers(1, vocab, int(rng.integers(35, 50)))
                             .tolist()),
                max_new_tokens=2), now)
            target += 1
            now = drain(now)
    return {tuple(r.tokens): list(r.output_tokens) for r in done}


def test_spec_exact_under_host_tier_thrash(small_model):
    kw = dict(max_context=64, chunk_size=16, max_batch_tokens=64,
              capacity_tokens=160, page_size=8,
              host_capacity_tokens=4096, prefetch_budget_tokens=256)
    vocab = small_model[0].vocab_size
    jeng, teng = _engines(small_model, _specs(small_model, True), **kw)
    jout = _pressure_waves(vocab, JRequest, jeng)
    assert _pressure_waves(vocab, TRequest, teng) == jout
    _same(jeng, teng)
    for k in ("demoted_tokens", "restored_tokens", "prefetch_issued"):
        assert teng.stats[k] == jeng.stats[k], k
    assert teng.stats["spec_accepted_tokens"] > 0
    assert teng.stats["demoted_tokens"] > 0
    assert teng.stats["restored_tokens"] > 0


def test_short_headroom_lanes_never_speculate(small_model):
    def waves(vocab, Request):
        rng = np.random.default_rng(0)
        return [(0, [Request(tokens=tuple(rng.integers(1, vocab, 12)
                                          .tolist()), max_new_tokens=1)
                     for _ in range(4)])]

    teng = _run(small_model, _specs(small_model, True), waves)
    assert teng.stats["spec_proposed_tokens"] == 0


def test_draft_pool_squeeze_degrades_not_crashes(small_model):
    """A draft pool too small for the lanes' pages degrades them to
    plain decode slots (spec_degraded), as in the JAX engine."""
    vocab = small_model[0].vocab_size
    specs = _specs(small_model, True)
    jeng, teng = _engines(small_model, specs)
    for eng in (jeng, teng):
        small = type(eng.draft.pool)(10, 16)
        assert small.reserve_page() == 0
        eng.draft.pool = small
    jout = _drive(jeng, _waves(vocab, JRequest, 21))
    assert _drive(teng, _waves(vocab, TRequest, 21)) == jout
    _same(jeng, teng)
    assert teng.stats["spec_degraded"] > 0


def test_draft_worker_rejects_unpageable_model(small_model):
    tcfg = small_model[2]
    bad = dataclasses.replace(tcfg, n_layers=1, attention_free=True)
    with pytest.raises(ValueError, match="paged"):
        DraftWorker(TSpec(draft_cfg=bad), TEngineConfig(**_econf()),
                    device="cpu")


def test_speculative_requires_fused_plane(small_model):
    _, _, tcfg, tparams = small_model
    spec = _specs(small_model, False)[1]
    for kw in (dict(fused=False), dict(paged=False)):
        with pytest.raises(ValueError, match="fused"):
            TEngine(tcfg, tparams, TEngineConfig(speculative=spec,
                                                 **_econf(**kw)),
                    device="cpu")


def test_random_draft_without_params_is_the_ports_own_draw(small_model):
    """Without draft_params the port draws the draft from a
    torch.Generator seeded with draft_seed: the same seed gives the same
    parameters, and the plane still runs token-exact against the
    non-speculative port engine."""
    _, _, tcfg, tparams = small_model
    spec = TSpec(draft_cfg=dataclasses.replace(tcfg, n_layers=1), k=3,
                 draft_seed=4)
    a = DraftWorker(spec, TEngineConfig(**_econf()), device="cpu")
    b = DraftWorker(spec, TEngineConfig(**_econf()), device="cpu")
    assert torch.equal(a.params["embed"]["tok"], b.params["embed"]["tok"])
    vocab = tcfg.vocab_size
    base = TEngine(tcfg, tparams, TEngineConfig(**_econf()), device="cpu")
    eng = TEngine(tcfg, tparams, TEngineConfig(speculative=spec,
                                               **_econf()), device="cpu")
    assert _drive(eng, _waves(vocab, TRequest, 9)) \
        == _drive(base, _waves(vocab, TRequest, 9))
    assert eng.stats["spec_proposed_tokens"] > 0
    assert not eng.draft.pool.tables
