"""The port's ClusterRuntime and serve CLI, and the gates that keep the
port free of JAX and of the JAX package.

The cluster scenario is tests/test_engine_cluster.py's fused end-to-end
run (E2 and round-robin, eviction pressure, a mid-flight failover),
replayed through the JAX cluster and the port's on the same float32
parameters and the same cost-model numbers: outputs and placements must
be identical.
"""

import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, reduced
from repro.core.cost_model import HardwareSpec as JHardwareSpec
from repro.core.global_scheduler import GlobalSchedulerConfig as JGSConfig
from repro.core.request import Request as JRequest
from repro.models import zoo as jzoo
from repro.serving.cluster import ClusterRuntime as JCluster
from repro.serving.engine import EngineConfig as JEngineConfig
from repro.serving.faults import FaultConfig as JFaultConfig
from repro_torch import bridge
from repro_torch.configs import ARCHS as TARCHS
from repro_torch.configs import reduced as treduced
from repro_torch.core.cost_model import CostModel, HardwareSpec, \
    cost_model_for
from repro_torch.core.global_scheduler import GlobalSchedulerConfig as \
    TGSConfig
from repro_torch.core.request import Request as TRequest
from repro_torch.serving.cluster import ClusterRuntime as TCluster
from repro_torch.serving.engine import EngineConfig as TEngineConfig
from repro_torch.serving.faults import FaultConfig as TFaultConfig

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
ENV = {**os.environ, "PYTHONPATH": str(ROOT / "src")}


@pytest.fixture(scope="module")
def small_model():
    kw = dict(n_layers=2, dtype="float32")
    jcfg = dataclasses.replace(reduced(ARCHS["smollm-360m"]), **kw)
    tcfg = dataclasses.replace(treduced(TARCHS["smollm-360m"]), **kw)
    jparams = jzoo.build(jcfg).init(jax.random.PRNGKey(0))
    tparams = bridge.tree_from_numpy(jax.tree.map(np.asarray, jparams),
                                     "cpu")
    return jcfg, jparams, tcfg, tparams


def _prompts(n=10, shared_len=24, tail=8, seed=11):
    rng = np.random.default_rng(seed)
    shared = tuple(rng.integers(1, 128, shared_len).tolist())
    return [shared + tuple(rng.integers(1, 128, tail).tolist())
            for _ in range(n)]


def _run_cluster(cl, Request, prompts):
    reqs = [Request(tokens=p, max_new_tokens=4) for p in prompts]
    for r in reqs:
        cl.submit(r, 0.0)
    placed = [r.instance for r in reqs]
    t = 0.0
    for _ in range(4):
        cl.step(t)
        t += 0.01
    cl.check_invariants()
    cl.fail_instance(0, t)            # rebalance mid-flight
    for _ in range(1500):
        cl.step(t)
        t += 0.01
        if all(r.state.value == "finished" for r in reqs):
            break
    assert all(r.state.value == "finished" for r in reqs)
    cl.check_invariants()
    return placed, [r.instance for r in reqs], \
        [list(r.output_tokens) for r in reqs]


@pytest.mark.parametrize("policy", ["e2", "rr"])
def test_cluster_matches_jax_cluster(small_model, policy):
    jcfg, jparams, tcfg, tparams = small_model
    econf = dict(max_context=64, chunk_size=16, max_batch_tokens=64,
                 capacity_tokens=512, page_size=16)
    jcl = JCluster(jcfg, jparams, num_instances=2, policy=policy,
                   engine_cfg=JEngineConfig(**econf))
    # the JAX package's cost-model numbers, so E2 prices alike
    cm = CostModel(hw=HardwareSpec(**dataclasses.asdict(JHardwareSpec())),
                   model=cost_model_for("smollm-360m").model)
    tcl = TCluster(tcfg, tparams, num_instances=2, policy=policy,
                   engine_cfg=TEngineConfig(**econf), cost_model=cm,
                   device="cpu")
    prompts = _prompts()
    assert _run_cluster(tcl, TRequest, prompts) \
        == _run_cluster(jcl, JRequest, prompts)
    assert any(e.stats["fused_iterations"] > 0
               for e in tcl.engines.values() if not e.failed)
    assert not tcl.gs.instances[0].alive


def _crash_mid_wave(cl, Request, prompts):
    """tests/test_faults.py's crash-mid-wave scenario without the host
    tier: wave 1 populates the cache, wave 2 re-hits it, the busiest
    instance dies inside its next step and the heartbeat detector (no
    oracle) hands its requests to the survivor."""
    reqs = [Request(tokens=p, max_new_tokens=4) for p in prompts]
    t = 0.0
    for r in reqs[:8]:
        cl.submit(r, t)
    for _ in range(600):
        cl.step(t)
        t += 0.01
        if len(cl.finished) == 8:
            break
    for r in reqs[8:]:
        cl.submit(r, t)
    cl.step(t)
    t += 0.01
    victim = max(cl.engines, key=lambda i: cl.engines[i].scheduler.depth)
    cl.faults.arm_crash(victim)
    for _ in range(2000):
        cl.step(t)
        t += 0.01
        if len(cl.finished) + len(cl.failed_requests) == 16:
            break
    assert cl.faults.stats["crashes"] == 1 and cl.engines[victim].failed
    assert cl.gs.stats["detected_dead"] == 1
    assert len(cl.finished) == 16 and not cl.failed_requests
    cl.check_invariants()
    return victim, [list(r.output_tokens) for r in reqs]


def test_crash_mid_wave_matches_jax_cluster(small_model):
    jcfg, jparams, tcfg, tparams = small_model
    econf = dict(max_context=64, chunk_size=16, max_batch_tokens=64,
                 capacity_tokens=128, page_size=16)
    gs = dict(capacity_tokens=128, heartbeat_interval=0.02,
              suspect_misses=2, dead_misses=5)
    jcl = JCluster(jcfg, jparams, num_instances=2,
                   engine_cfg=JEngineConfig(**econf),
                   scheduler_cfg=JGSConfig(**gs),
                   fault_config=JFaultConfig(seed=0))
    cm = CostModel(hw=HardwareSpec(**dataclasses.asdict(JHardwareSpec())),
                   model=cost_model_for("smollm-360m").model)
    tcl = TCluster(tcfg, tparams, num_instances=2,
                   engine_cfg=TEngineConfig(**econf),
                   scheduler_cfg=TGSConfig(**gs), cost_model=cm,
                   fault_config=TFaultConfig(seed=0), device="cpu")
    prompts = _prompts(n=8, shared_len=32, tail=24, seed=0) * 2
    assert _crash_mid_wave(tcl, TRequest, prompts) \
        == _crash_mid_wave(jcl, JRequest, prompts)


def test_cluster_elastic_add_instance(small_model):
    _, _, tcfg, tparams = small_model
    cl = TCluster(tcfg, tparams, num_instances=2, device="cpu",
                  engine_cfg=TEngineConfig(max_context=64, chunk_size=16,
                                           max_batch_tokens=64,
                                           capacity_tokens=4096,
                                           page_size=16))
    reqs = [TRequest(tokens=p, max_new_tokens=4)
            for p in _prompts(n=8, seed=5)]
    for r in reqs:
        cl.submit(r, 0.0)
    cl.step(0.0)
    cl.fail_instance(0, 0.1)
    assert cl.add_instance(tcfg, tparams, 0.2) == 2
    t = 0.2
    for _ in range(800):
        cl.step(t)
        t += 0.01
        if all(r.state.value == "finished" for r in reqs):
            break
    assert all(r.state.value == "finished" for r in reqs)
    assert cl.gs.instances[2].alive and not cl.gs.instances[0].alive
    cl.check_invariants()
    # elastic add of a 2-chip instance, checked as the JAX package's
    # add_instance registers one: aggregate capacity, a chips-derived
    # cost model, its own submesh
    ec2 = TEngineConfig(max_context=64, chunk_size=16, max_batch_tokens=64,
                        capacity_tokens=4096, page_size=16,
                        chips_per_instance=2)
    assert cl.add_instance(tcfg, tparams, 0.3, engine_cfg=ec2) == 3
    st = cl.gs.instances[3]
    assert st.capacity_tokens == 2 * 4096
    assert st.cost_model.prefill_a * 2 == pytest.approx(
        cl.gs.cost_model.prefill_a)
    assert cl.engines[3].mesh.size == 2 and cl.engines[2].mesh is None
    cl.fail_instance(2, 0.3)
    r = TRequest(tokens=_prompts(n=1, seed=6)[0], max_new_tokens=4)
    assert cl.submit(r, 0.3) == 3
    t = 0.3
    for _ in range(400):
        cl.step(t)
        t += 0.01
        if r.state.value == "finished":
            break
    assert r.state.value == "finished" and len(r.output_tokens) == 4
    cl.check_invariants()


def test_cluster_telemetry_binds_engine_series(small_model):
    from repro_torch.serving.telemetry import Telemetry
    _, _, tcfg, tparams = small_model
    tel = Telemetry()
    cl = TCluster(tcfg, tparams, num_instances=2, telemetry=tel,
                  device="cpu",
                  engine_cfg=TEngineConfig(max_context=64, chunk_size=16,
                                           max_batch_tokens=64,
                                           capacity_tokens=4096,
                                           page_size=16))
    reqs = [TRequest(tokens=p, max_new_tokens=3)
            for p in _prompts(n=4, seed=3)]
    assert len(cl.run(reqs, dt=0.01)) == 4
    prom = tel.to_prometheus()
    assert "engine_model_dispatches" in prom
    assert "sched_used_tokens" in prom
    assert len(tel.traces) == 4


def test_serve_entrypoint_on_cpu():
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--reduced",
         "--device", "cpu", "--instances", "2", "--requests", "8",
         "--max-context", "64"],
        capture_output=True, text=True, env=ENV, cwd=ROOT, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "finished=8/8" in r.stdout
    assert "prefix reuse" in r.stdout


def test_port_imports_with_jax_blocked():
    """Every module of the port imports with jax unavailable (the
    training modules among them), and none pulls in the JAX package."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "import repro_torch.launch.serve\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'repro' "
        "or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "need = {'repro_torch.train.optimizer', "
        "'repro_torch.train.train_loop', 'repro_torch.train.checkpoint', "
        "'repro_torch.launch.train', 'repro_torch.train.sharded'}\n"
        "assert need <= set(sys.modules), need - set(sys.modules)\n"
        "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=ENV, cwd=ROOT, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == "ok"


_FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)",
                        re.MULTILINE)


def test_no_jax_or_reference_imports_in_the_port():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    examples = sorted((ROOT / "examples" / "torch").glob("*.py"))
    assert [f.name for f in examples] == [
        "distributed_serving.py", "quickstart.py", "train_smollm.py"]
    files += examples
    assert len(files) > 20
    for f in files:
        text = f.read_text()
        assert not _FORBIDDEN.search(text), f
        assert "import jax" not in text, f
