"""The port's distributed-serving example
(examples/torch/distributed_serving.py) against the JAX package's
(examples/distributed_serving.py), in float32.

The JAX side is the shipped example's ``main()`` with its config in
float32; the port side is ``run(cfg, "cpu", params)`` on the same
``PRNGKey(0)`` parameters. Every printed figure comes from simulated
time and the schedulers' decisions, so the lines are equal: finished
counts, prefill-saved, avg and p99 of both policies, the rerouted count
and "OK" (the cluster's outputs are held token for token by
tests/test_torch_cluster.py). The JAX example's 8+ engines share their
jitted functions, as in tests/test_torch_offload.py: each JAX engine
jits afresh and would recompile every batch shape.
"""

import dataclasses

import jax
import torch

from repro.configs import get_config, reduced
from repro.models import zoo as jzoo
from repro.serving import cluster as jcluster
from repro.serving.engine import Engine as JEngine
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import reduced as treduced
from test_torch_example_quickstart import (float32_config, jax_lines,
                                           load_example, port_params)

torch.set_num_threads(1)

_JIT_ATTRS = ("_decode_paged_fn", "_extend_paged_fn", "_mixed_paged_fn",
              "_copy_page_fn", "_gather_pages_fn", "_scatter_tokens_fn")
_JITS = {}


def _shared_jit_engine(*args, **kw):
    """A JAX engine whose jitted functions are the first engine's of the
    same parameters (they depend on nothing else: the pool and the batch
    are arguments)."""
    eng = JEngine(*args, **kw)
    for name in _JIT_ATTRS:
        if hasattr(eng, name):
            key = (name, id(eng.params))
            # the entry holds the parameters, so their id stays theirs
            setattr(eng, name, _JITS.setdefault(
                key, (eng.params, getattr(eng, name)))[1])
    return eng


def test_distributed_serving_matches_the_jax_example(monkeypatch, capsys):
    jd = load_example("examples/distributed_serving.py",
                      "jax_distributed_example")
    td = load_example("examples/torch/distributed_serving.py",
                      "torch_distributed_example")
    float32_config(monkeypatch, jd)
    monkeypatch.setattr(jcluster, "Engine", _shared_jit_engine)
    want = jax_lines(jd, capsys)
    kw = dict(n_layers=2, dtype="float32")
    jcfg = dataclasses.replace(reduced(get_config("smollm-360m")), **kw)
    tcfg = dataclasses.replace(treduced(tget_config("smollm-360m")), **kw)
    params = port_params(jzoo.build(jcfg).init(jax.random.PRNGKey(0)))
    res = td.run(tcfg, "cpu", params=params)
    assert res["lines"] == want
    assert len(want) == 6 and want[-1] == "OK"
    e2, rr = res["results"]["e2"], res["results"]["rr"]
    assert e2["done"] == rr["done"] == 24
    assert e2["reuse_frac"] > rr["reuse_frac"]
    assert res["rerouted"] >= 1
    assert all(r.state.value == "finished" for r in res["extra"])
    assert not e2["cluster"].gs.instances[0].alive


def test_distributed_serving_port_runs_as_shipped():
    """The port example at its own config (bfloat16), its own parameters:
    the example's assertions hold and every request finishes."""
    td = load_example("examples/torch/distributed_serving.py",
                      "torch_distributed_shipped")
    cfg = dataclasses.replace(treduced(tget_config("smollm-360m")),
                              n_layers=2)
    assert cfg.dtype == "bfloat16"
    res = td.run(cfg, "cpu")
    assert res["lines"][-1] == "OK"
    assert all(r["done"] == 24 for r in res["results"].values())
