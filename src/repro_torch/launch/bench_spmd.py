"""Tensor-parallel data-plane bench (counterpart of the JAX package's
``benchmarks/bench_spmd.py``).

    PYTHONPATH=src python -m repro_torch.launch.bench_spmd [--device cpu]

Runs the SAME shared-prefix workload through real engine forwards at TP
degrees 1 / 2 / 4 with the per-chip pool FIXED (2048 tokens) on reduced
smollm-360m (2 layers, float32), and fails unless:

  * every run is token-exact against the single-device DENSE oracle;
  * the fused plane issues exactly 1.0 model dispatches per iteration;
  * the device pool's tokens grow by 2048 per added chip.

Prints the reference's columns, one CSV row per TP degree, then one per
shard (per-shard resident pool tokens from the telemetry registry). On
the CPU the shards are emulated; with ``--device cuda`` (the default)
every shard of a submesh is placed on card 0, as ``chip_smoke.py``
emulates a submesh on one card. The walls are host wall seconds of the
whole run, not device times.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..configs import ARCHS, reduced
from ..core.request import Request
from ..models import zoo
from ..serving.engine import Engine, EngineConfig
from ..serving.telemetry import Telemetry

PER_CHIP_TOKENS = 2048
CHIPS = (1, 2, 4)


def _econf(chips: int, paged=None) -> EngineConfig:
    return EngineConfig(max_context=96, chunk_size=16, max_batch_tokens=96,
                        max_batch_requests=16,
                        capacity_tokens=PER_CHIP_TOKENS, page_size=16,
                        paged=paged, chips_per_instance=chips)


def _waves(vocab: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    shared = tuple(rng.integers(1, vocab, 24).tolist())

    def wave(n, s2):
        rr = np.random.default_rng(s2)
        return [Request(tokens=shared
                        + tuple(rr.integers(1, vocab,
                                            int(rr.integers(6, 24)))
                                .tolist()),
                        max_new_tokens=int(rr.integers(3, 7)))
                for _ in range(n)]

    return [(0, wave(4, seed + 1)), (4, wave(4, seed + 2))]


def _drive(eng: Engine, waves, max_iters: int = 2000) -> List[Request]:
    done, now = [], 0.0
    total = sum(len(rs) for _, rs in waves)
    for it in range(max_iters):
        for at, rs in waves:
            if at == it:
                for r in rs:
                    eng.scheduler.enqueue(r, now)
        done += eng.step(now)
        now += 0.01
        if len(done) == total and it >= max(at for at, _ in waves):
            break
    if len(done) != total:
        raise RuntimeError("bench workload did not finish")
    return done


def _outs(done):
    return {(tuple(r.tokens), r.max_new_tokens): list(r.output_tokens)
            for r in done}


def run(device: str = "cuda") -> Tuple[List[Dict], List[Dict]]:
    """The bench's rows (one per TP degree) and shard rows; raises when a
    gate fails."""
    cfg = dataclasses.replace(reduced(ARCHS["smollm-360m"]), n_layers=2,
                              dtype="float32")
    dev = torch.device(device)
    # the port's own draw from seed 0
    params = zoo.build(cfg).init(torch.Generator().manual_seed(0), "cpu")
    oracle = _outs(_drive(Engine(cfg, params, _econf(1, paged=False),
                                 device=dev), _waves(cfg.vocab_size)))
    rows, shard_rows, pool_tokens = [], [], {}
    for chips in CHIPS:
        ec = _econf(chips)
        tel = Telemetry()
        eng = Engine(cfg, params, ec, device=dev,
                     devices=[dev] * chips if chips > 1 else None)
        eng.attach_telemetry(tel)
        t0 = time.perf_counter()
        outs = _outs(_drive(eng, _waves(cfg.vocab_size)))
        wall = time.perf_counter() - t0
        if outs != oracle:
            raise RuntimeError(f"chips={chips}: the sharded fused plane "
                               "diverged from the single-device dense "
                               "oracle")
        dpi = eng.stats["model_dispatches"] / max(eng.stats["iterations"], 1)
        if dpi != 1.0:
            raise RuntimeError(f"chips={chips}: {dpi:.3f} model dispatches "
                               "per iteration")
        toks = eng.pool.num_pages * ec.page_size
        pool_tokens[chips] = toks
        if chips > 1 and toks - pool_tokens[1] != (chips - 1) \
                * PER_CHIP_TOKENS:
            raise RuntimeError(f"chips={chips}: the device pool grew "
                               f"{toks - pool_tokens[1]} tokens over 1 chip")
        rows.append({
            "chips": chips, "wall_s": wall, "dispatches_per_iter": dpi,
            "device_pool_tokens": toks, "per_chip_tokens": PER_CHIP_TOKENS,
            "reused_tokens": eng.stats["reused_tokens"],
            "shard_dma_s": eng.stats["shard_dma_seconds"],
            "collective_s": eng.stats["collective_seconds"]})
        for s in range(chips if chips > 1 else 0):
            g = tel.registry.get("engine_shard_pool_tokens",
                                 instance=ec.instance_id, shard=s)
            shard_rows.append({
                "chips": chips, "shard": s,
                "pool_tokens": g if g is not None else 0,
                "shard_dma_s": eng.stats["shard_dma_seconds"],
                "collective_s": eng.stats["collective_seconds"]})
    return rows, shard_rows


def _csv(rows: Sequence[Dict]) -> None:
    keys = list(rows[0])
    print(",".join(keys))
    for r in rows:
        print(",".join(f"{r[k]:.6g}" if isinstance(r[k], float)
                       else str(r[k]) for k in keys))


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device the shards run on")
    args = ap.parse_args(argv)
    rows, shard_rows = run(args.device)
    _csv(rows)
    _csv(shard_rows)
    print("spmd gates passed: exactness, 1.0 dispatches/iter, pooled "
          "capacity scaling")


if __name__ == "__main__":
    main()
