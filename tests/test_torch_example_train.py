"""The port's training example (examples/torch/train_smollm.py) against
the JAX package's (examples/train_smollm.py), in bfloat16 as shipped.

Both sides run the default variant (4 layers, d 256) for the same
``--steps`` on the same synthetic stream, from the same ``PRNGKey(0)``
parameters (bridged as uint16 bit views). The model line, the logged
steps, the checkpoint step and "OK" are equal, and every printed loss
is within LOSS_RTOL relative. The JAX example is not run in float32: its
``donate_argnums=(0,)`` then fails with "Attempt to donate the same
buffer twice" (the float32 state's masters alias its parameters).
"""

import dataclasses
import re
import sys

import jax
import torch

from repro.configs import get_config
from repro.models import zoo as jzoo
from test_torch_example_quickstart import (jax_lines, load_example,
                                           port_params)

torch.set_num_threads(1)

STEPS = 40
VARIANT = dict(n_layers=4, d_model=256, n_heads=4, n_kv_heads=2, d_ff=1024,
               vocab_size=2048, head_dim=64)     # the JAX example's
# bfloat16 sums in another order on each side: over 40 steps the printed
# losses drifted 2.9e-3 relative at worst (step 20)
LOSS_RTOL = 5e-3
_LOSS = re.compile(r"loss[= ](\d+\.\d+)(?: -> (\d+\.\d+))?")


def losses(lines):
    return [float(x) for ln in lines for m in _LOSS.finditer(ln)
            for x in m.groups() if x is not None]


def test_train_example_matches_the_jax_example(monkeypatch, capsys):
    jt = load_example("examples/train_smollm.py", "jax_train_example")
    tt = load_example("examples/torch/train_smollm.py",
                      "torch_train_example")
    monkeypatch.setattr(sys, "argv", ["train_smollm.py", "--steps",
                                      str(STEPS)])
    want = jax_lines(jt, capsys)
    cfg, batch, seq = tt.variant(False)
    jcfg = dataclasses.replace(get_config("smollm-360m"), **VARIANT)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    params = port_params(jzoo.build(jcfg).init(jax.random.PRNGKey(0)))
    res = tt.run(cfg, "cpu", STEPS, batch, seq, params=params)
    got = res["lines"]
    assert len(got) == len(want) == 6
    shape = [re.sub(r"\d+\.\d+", "x", ln) for ln in got]
    assert shape == [re.sub(r"\d+\.\d+", "x", ln) for ln in want]
    assert got[0] == want[0] and got[2] == want[2] and got[-1] == "OK"
    assert got[2] == f"-- checkpoint at step {STEPS // 2}; simulating " \
                     "restart --"
    assert res["restored_step"] == res["half"] == STEPS // 2
    a, b = losses(got), losses(want)
    assert len(a) == len(b) == 4
    for x, y in zip(a, b):
        assert abs(x - y) <= LOSS_RTOL * abs(y), (a, b)
