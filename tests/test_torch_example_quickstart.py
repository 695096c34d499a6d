"""The port's quickstart (examples/torch/quickstart.py) against the JAX
package's (examples/quickstart.py), and the gates every port example
shares.

The JAX side is the shipped example's ``main()``, run in-process with
its stdout captured; the port side is ``run(cfg, "cpu", params)`` on the
same ``PRNGKey(0)`` parameters, bridged through numpy (bfloat16 leaves
as uint16 bit views). Request ids come from a process-wide counter, so
each run's ids are compared as offsets from its first. In float32 every
line is equal, output tokens included; in bfloat16 (as shipped) a
greedy near-tie may pick another token, so there only the cached counts,
the reuse line and "OK" are held.
"""

import dataclasses
import importlib.util
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.models import zoo as jzoo
from repro_torch import bridge
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import reduced as treduced

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
ENV = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
EXAMPLES = ("quickstart", "distributed_serving", "train_smollm")


def load_example(rel, name):
    """Import an example file as a module of its own name (the JAX and
    port examples share file names)."""
    spec = importlib.util.spec_from_file_location(name, ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def port_params(jparams):
    """JAX parameters -> the port's on the CPU (bfloat16 as uint16)."""
    def to_np(a):
        a = np.asarray(a)
        return a.view(np.uint16) if a.dtype == jnp.bfloat16 else a
    return bridge.tree_from_numpy(jax.tree.map(to_np, jparams), "cpu")


def float32_config(monkeypatch, mod):
    """Have a JAX example's ``get_config`` (bound when it was imported)
    return its config in float32."""
    monkeypatch.setattr(mod, "get_config", lambda name: dataclasses.replace(
        get_config(name), dtype="float32"))


def relative_ids(lines):
    """"req <id>:" rewritten as the offset from the first printed id."""
    ids = [int(m) for m in re.findall(r"^req (\d+):", "\n".join(lines),
                                      re.MULTILINE)]
    return [re.sub(r"^req (\d+):", lambda m: f"req +{int(m[1]) - ids[0]}:",
                   ln) for ln in lines]


def jax_lines(mod, capsys):
    capsys.readouterr()
    mod.main()
    return capsys.readouterr().out.splitlines()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quickstart_matches_the_jax_example(monkeypatch, capsys, dtype):
    jq = load_example("examples/quickstart.py", "jax_quickstart_example")
    tq = load_example("examples/torch/quickstart.py",
                      "torch_quickstart_example")
    if dtype == "float32":
        float32_config(monkeypatch, jq)
    want = relative_ids(jax_lines(jq, capsys))
    jcfg = dataclasses.replace(reduced(get_config("smollm-360m")),
                               dtype=dtype)
    tcfg = dataclasses.replace(treduced(tget_config("smollm-360m")),
                               dtype=dtype)
    params = port_params(jzoo.build(jcfg).init(jax.random.PRNGKey(0)))
    res = tq.run(tcfg, "cpu", params=params)
    got = relative_ids(res["lines"])
    assert len(got) == len(want) == 7
    if dtype == "float32":
        assert got == want
    else:
        # every line but the output tokens: the model, each request's
        # cached counts, the reuse line and "OK"
        cut = [ln.split(" -> output")[0] for ln in got]
        assert cut == [ln.split(" -> output")[0] for ln in want]
    assert got[-2].startswith("prefix cache saved 73% ")
    assert [r.cached_len for r in res["done"]] == [0] + [30] * 7


@pytest.mark.parametrize("name", EXAMPLES)
def test_port_examples_raise_without_a_card(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    mod = load_example(f"examples/torch/{name}.py", f"torch_{name}_card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(["--device", "cuda"])


def test_port_examples_load_and_run_without_jax():
    """All three port examples load with jax blocked, the quickstart runs
    to its "OK" on the CPU, and no module of the JAX package is loaded."""
    code = (
        "import importlib.util, sys\n"
        "sys.modules['jax'] = None\n"
        "mods = {}\n"
        f"for n in {EXAMPLES!r}:\n"
        "    spec = importlib.util.spec_from_file_location(\n"
        "        'torch_' + n, f'examples/torch/{n}.py')\n"
        "    mods[n] = importlib.util.module_from_spec(spec)\n"
        "    spec.loader.exec_module(mods[n])\n"
        "mods['quickstart'].main(['--device', 'cpu'])\n"
        "bad = [m for m in sys.modules if m == 'repro' "
        "or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print('loaded', len(mods))\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=ENV, cwd=ROOT, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.splitlines()[-2:] == ["OK", "loaded 3"]
