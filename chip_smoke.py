#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

From the root of a checkout. It

1. prints the card's name and power limit and builds every CUDA kernel
   of the port from ``src/repro_torch/kernels/csrc`` (one nvcc per
   source, started together);
2. holds each kernel against its plain PyTorch version on the card, on
   every (dtype, G, D) instantiation, on the JAX package's paged test
   shapes, and on the main-path shapes of full-width smollm-360m, and
   times kernel, plain version and a PyTorch library call at those
   shapes with CUDA events, beside the least time the card could take,
   with the paged kernel's split plan (n_splits, grid blocks) and
   occupancy at each shape; also at mistral-7b's width (G 4, D 128,
   8 lanes of up to 1024 tokens). Wherever the paged or split-K kernel
   is held against its plain version (here and in every later phase),
   its one-launch output (the last split block of each (lane, head)
   merges) must also equal the same kernel's partials merged by the
   standalone lse_merge_kernel, bit for bit. Then the standalone merge
   alone, at 8-50 slots and the head widths of smollm-360m, mistral-7b
   and mixtral-8x22b, bf16 and float32, against its plain version and
   timed beside its bound and a launch floor (a one-element torch.add);
3. drives the kernel library (``repro_torch.kernels.bench.run``, the
   counterpart of the JAX package's ``benchmarks/bench_kernels.py``)
   on the card with every launch count at 0, holds the split-K decode,
   shared-prefix and flash kernels against their plain versions on every
   built instantiation (decode also on splits that wrap its stage ring,
   prefix also on its raw partial) and on the JAX package's test cases,
   and times each at full smollm-360m and mistral-7b head widths beside
   its bound, its plain version and a PyTorch yardstick, with the split
   plans and occupancy launched;
4. serves a generated workload through ``repro_torch.launch.serve`` at
   the full width of smollm-360m (32 layers, d 960, 15/5 heads, bf16,
   random weights from the seed) on two engine instances, and checks
   that every request finished with prefix reuse, on the card, through
   the kernel (its launch count = layers x model dispatches), every
   pure-decode step a CUDA graph replay; each replay runs again under
   torch.profiler (one paged split kernel a layer a replay in the
   device trace) and beside the eager forward on its inputs (the same
   tokens on every lane);
5. drives the host KV tier at full smollm-360m width: two instances under
   E2 whose device pools hold about a quarter of a thrashing 6-prefix
   working set (videoqa/loogle-style interleaved rounds), with host
   tiers and prefetch; checks that KV was demoted, restored and
   prefetched, that the cluster's invariants hold, that the same stream
   without the tier prefills strictly more, and the kernel's launch
   count; prints the copy rates of each direction (CUDA events on the
   stream that ran the copy), the host wall blocked in drains and both
   overlap fractions;
6. drives draft-model speculative decoding at full width: a 32-layer
   target whose layers 4-31 are identities on the residual, and its
   first 4 layers as the draft (K 4), on 8 toolbench requests; checks
   one target dispatch per iteration, draft dispatches, no leaked draft
   table and the kernel's launch count (target and draft); prints the
   acceptance and tokens/s with speculation on and off;
7. serves mistral-7b at full width (32 layers, d 4096, 32/8 heads,
   D 128, d_ff 14336, bf16, random weights from the seed, ~14.5 GB) on
   one engine, 8 toolbench requests in two waves, once on the automatic
   plane (paged fused) and once with paged=False; checks that every
   request finished with prefix reuse on both, that the dense plane's
   decode ran the split-K decode kernel (32 launches a decode batch) and
   never the paged one, and the paged plane the reverse; prints steps,
   dispatches, reuse, wall, peak memory and the share of tokens on which
   the two planes agree; holds the paged plane's pure-decode graph
   replays to the device trace and to the eager forward as in step 4,
   at mistral-7b's width, the eager calls' paged inputs kept; then holds
   each of the two kernels against its plain version on every input
   (shapes, lens, page tables) its plane gave it, fused and pure-decode
   steps alike, times the last of each lane count; then, on the same weights
   (after the TP phase of step 10), profiles one paged fused engine with
   the cluster simulator's batching (chunk 512, 4096 tokens a step):
   steps of 1, 2, 4 and 8 distinct 512-token prompts (no reuse) and
   decode-only steps of 1-32 lanes at contexts near 1024, each step
   timed by the host clock between synchronizes, one prefill and one
   decode step also under torch.profiler; fits ``CostModel.fit`` to
   them, prints the data-sheet and fitted coefficients and each step's
   wall beside both models' ``batch_time``, checks the paged kernel's
   launches (layers x dispatches), and runs the port's simulator on
   ``benchmarks/bench_e2e.py``'s quick Figure 3 grid at 1, 2, 4 and 8
   times its rates, E2 and round-robin under both models (every request
   finished, invariants held; avg / p99 latency, TTFT, cache hits and
   the round-robin / E2 ratios printed); and frees the weights;
8. serves the MoE models at full width (d 6144, 48/8 heads, D 128, 8
   experts, top 2, bf16, random weights from the seed), cut in depth to
   what the card holds: mixtral-8x22b (d_ff 16384, 12 of 56 layers,
   56.7 GiB) on the automatic plane (paged fused) and with paged=False,
   grok-1-314b (d_ff 32768, vocab 131072, 6 of 64 layers, 58.0 GiB) on
   the paged plane, the mistral phase's stream; the same checks as step 7
   (the G 6 instantiations of the paged and split-K kernels), plus the
   routed MoE's calls, experts hit and host syncs a step; then mixtral
   cut to 2 layers at TP 1, 2 and 4 (the expert-parallel arm: 8 / 4 / 2
   experts a shard), the first dispatch's float32 logits against TP 1's;
9. checks the served outputs against the same engine on the CPU on
   small float32 configs (token-identical): smollm-360m on the paged and
   the dense plane, mistral-7b on the dense plane, and raw mistral-7b's
   prefill and decode steps past its window (the ring cache wraps);
   reduced grok-1-314b and mixtral-8x22b on the dense plane and on the
   paged plane at TP 1, 2 and 4; the half-expert MoE at TP 4 and 8 on
   the card against moe_full on the CPU;
10. tensor-parallel instances, each submesh's shards on the one card:
   full-width mistral-7b (the weights of step 7) on the paged fused
   plane at TP 1, 2 and 4 (head-wise pools) with one dispatch per step,
   paged-kernel launches = 32 x shards x dispatches, per-shard pool and
   weight bytes 1/tp of TP 1's, every kernel input the shards gave held
   against the plain version, and the first dispatch's logits against
   TP 1's; full-width smollm-360m at TP 2 (slot-wise pool, replicated
   heads), whose slot shards' partials launches and the merge across
   shards are held against their plain versions on the served inputs
   (empty shards included) and timed; reduced float32 smollm-360m and
   mistral-7b token-identical at TP 1, 2 and 4 and on the card == on
   the CPU; and a heterogeneous [2, 1] cluster with host tiers that
   executes an E2 migration and a drain migration, card == CPU;
11. profiles a second, smaller full-width serve with torch.profiler:
   device busy share, launches per step, the costliest kernels, and the
   paged decode kernel's launches, device time a call and share of device
   time; it fails unless every paged call was one launch of the split
   kernel and no merge kernel ran (the profiled dense mistral-7b serve of
   step 7 is held to the same for the split-K kernel);
12. (right after the MoE phase) the recurrent, hybrid and cross-attention
   stacks on the dense plane at full width, random bf16 weights from the
   seed, each freed before the next: rwkv6-7b (32 layers), jamba-v0.1-52b
   (16 of 32 layers) and llama-3.2-vision-11b (40 layers), one engine
   each over 8 embodied-agent requests and a repeat of the first, each
   enqueued after the previous one finished (max context 4096, chunk 64):
   every request finished, reuse > 0, every extension reusing at least
   the previous prompt_len - 1 tokens (the snapshot boundary), the
   repeat's outputs equal to the first's, split-K launches = its calls a
   decode batch (0 / 2 / 48) x decode batches, every split-K input held
   against the plain version and timed; whisper-tiny in float32 (1500
   encoder frames, 8 decode steps each equal to a full prefill); one
   full-width float32 layer of mamba and of RWKV-6, chunk form against
   chained steps; and (after the MoE reference phase) the reduced
   float32 rwkv6, jamba and VLM dense engines on the snapshot stream,
   card == CPU;
13. (right after the recurrent phase) training: smollm-360m at full width
   and depth (bf16, random weights from seed 0), 12 steps of the port's
   ``make_train_step`` at ``TrainConfig()`` defaults (remat on) on
   batch 8 x seq 1024 of the synthetic stream: each step's loss, grad
   norm and lr, the step wall, tokens/s, the model-FLOP share, peak
   memory against the state's bytes and one profiled step (launches,
   device busy share, device time by kernel kind); 12 steps on one
   fixed batch at the reference's overfit settings, whose last loss
   must be below its first; one step each of grad_accum 2, int8 error
   feedback and int8 moments (moment bytes); ``launch.train.main`` with
   a checkpoint, its restored state bit-equal to the saved one, a step
   from each within the bf16 bound, and a second call that resumes;
   and one float32 step of six reduced families (smollm, mixtral,
   rwkv6, jamba, the VLM with vision, whisper with frames) card == CPU.
   Training runs no hand-written kernel, as in the JAX package.
14. (right after the training phase) the dry-run and its roofline
   (``repro_torch.launch.dryrun``): ``--list`` (33 RUN, 7 SKIP); the meta
   dry-run of smollm-360m train_4k, prefill_32k and decode_32k and of
   mixtral-8x22b train_4k (half-expert, cut to 4 of its 56 layers) and
   decode_32k (routed) on the one-pod mesh (16, 16), each record's H100
   roofline row and count wall; then smollm-360m at full width and depth
   on a 1 x 1 mesh on the card for three cuts of its cells (train 8 x
   1024, prefill 1 x 32768 blockwise, decode 8 lanes against a 32768-token
   cache through the split-K kernel): the dot FLOPs, dot bytes and
   kernel counts on the card must equal the meta count of the same cut,
   and each cut's step wall (CUDA events, median and spread of 5 after a
   warm-up), model FLOPs, model-FLOP share, roofline bound over the wall,
   peak memory against the argument bytes and one profiled step (device
   busy share, launches) are printed; the split-K kernel at the decode
   cut's shape is held against its plain version and timed beside its
   bound and SDPA. The training phase's model-FLOP share also comes from
   ``model_flops_for``.
15. (right after the dry-run phase) the three examples of
   ``examples/torch/``, each driven through its ``run`` (or its
   ``main``): the quickstart at its own size (reduced smollm-360m,
   bf16), in float32 at that size with the card's lines equal to the
   CPU's token for token, and at full smollm-360m width and depth with
   the example's EngineConfig and 8 requests (reuse > 0.4, 30 of 36
   prompt tokens cached on every request after the first, paged
   launches = layers x dispatches, the wall); distributed serving at
   full width and depth, 4 instances on the one card, E2 then
   round-robin then the failover (finished counts, prefill-saved, E2 >=
   RR, simulated avg and p99, each policy's host wall, the rerouted
   count, paged launches = layers x the eight engines' dispatches); and
   the train example's default variant and ``--full`` (12 layers at
   smollm-360m width, 8 x 512) through its main, 120 steps each, and
   ``--full`` again through ``run`` with parameters drawn at
   TRAIN_FAN_IN_GAIN (under the reference's scale that stack's loss
   stays flat; its assertion holds on the batches): first and final
   loss, the restored checkpoint step, step wall, tokens/s, peak memory
   and checkpoint bytes.

Any failed check exits non-zero. The last line is the JSON result.
Exits non-zero with no result when no CUDA device is present or when
run outside a checkout of the repo.
"""

import contextlib
import functools
import gc
import importlib
import importlib.util
import io
import json
import math
import random
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

SPIN_CYCLES = 2_000_000        # ~1 ms at the H100's 1.98 GHz boost clock
SERVE_ARGS = ["--arch", "smollm-360m", "--instances", "2", "--requests",
              "16", "--max-context", "1024", "--device", "cuda"]


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(ok: bool, msg: str) -> None:
    if not ok:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# kernel vs plain
# ---------------------------------------------------------------------------

def paged_inputs(torch, B, H, KH, PS, P, D, dtype, lens, seed):
    """Random q and pool on the card; each lane gets P distinct pages
    (page 0 stays the scratch page, as in the engine)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    n_pages = B * P + 1
    k = torch.randn(n_pages, PS, KH, D, generator=g, device="cuda")
    v = torch.randn(n_pages, PS, KH, D, generator=g, device="cuda")
    q = torch.randn(B, H, D, generator=g, device="cuda")
    perm = torch.randperm(n_pages - 1, generator=g, device="cuda") + 1
    pt = perm[:B * P].view(B, P).to(torch.int32).contiguous()
    lens = torch.tensor(lens, dtype=torch.int32, device="cuda")
    return q.to(dtype), k.to(dtype), v.to(dtype), pt, lens


F32 = dict(atol=3e-5, rtol=1e-4)           # summation order only
# bf16: kernel and plain version round nearly the same f32 result once to
# bf16, so an element may differ by one bf16 ulp (at most 2^-7 |x|) plus
# their f32 difference. That difference (flash rounds P to bf16 before
# P V, the plain version does not) is held to 2^-6 of the rms of the
# element's output row, the last dimension (PERF.md has the readings).
# A tile of keys lost, stale or read twice moves a row by a large share
# of its rms.
BF16 = dict(atol=0.0, rtol=2 ** -7, row_rtol=2 ** -6)
BOUND_USE = {}          # kernel -> largest |kernel - plain| / bound, bf16


def close(torch, name, got, exp, tol):
    """Max |got - exp|, after failing unless every element is finite and
    within atol + rtol * |exp| (+ row_rtol * the rms of exp's last-dim
    row). Under BF16 it also keeps the largest share of the bound used,
    per kernel (the first word of ``name``)."""
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got.float()).all()), f"{name}: non-finite")
    g, e = got.float(), exp.float()
    err = (g - e).abs()
    bound = tol["atol"] + tol["rtol"] * e.abs()
    if tol.get("row_rtol"):
        bound = bound + tol["row_rtol"] * e.pow(2).mean(-1, True).sqrt()
    use = torch.where(err == 0, 0.0, err / bound).max().item()
    check(use <= 1.0,
          f"{name}: max |kernel - plain| {err.max().item():.3e}, "
          f"{use:.3g}x its bound {tol}")
    if tol is BF16:
        kind = name.split()[0]
        BOUND_USE[kind] = max(BOUND_USE.get(kind, 0.0), use)
    return err.max().item()


def partial_close(torch, name, got, q, kp, vp, plain):
    """prefix_partial's raw (acc, m, l) against the plain version's. m and
    l: f32 on both sides from the same scores (summation order only:
    atol 1e-3, rtol 1e-4, as the f32 check). acc: the bf16 kernel rounds
    each probability p to bf16 before P V (as the Pallas kernel does), an
    error of at most 2^-8 p, so |acc - plain| <= 2^-8 sum_k p_k |v_k|;
    held to 2^-7 of that sum (the f32 sums' own rounding on top), plus
    the f32 tolerance. A lost or doubled key tile fails on l."""
    acc_p, m_p, l_p = plain(q, kp, vp)
    close(torch, f"{name} m", got[1], m_p, dict(atol=1e-3, rtol=1e-4))
    close(torch, f"{name} l", got[2], l_p, dict(atol=1e-3, rtol=1e-4))
    tol = torch.zeros_like(acc_p) + 1e-3 + 1e-4 * acc_p.abs()
    if q.dtype == torch.bfloat16:
        tol = tol + 2 ** -7 * plain(q, kp, vp.abs())[0]
    err = (got[0] - acc_p).abs()
    check(bool(torch.isfinite(got[0]).all()) and bool((err <= tol).all()),
          f"{name} acc: max |kernel - plain| {err.max().item():.3e}, "
          f"{(err / tol).max().item():.3g}x its bound")


def one_launch_equal(torch, name, kind, inp):
    """The one-launch paged ("paged") or split-K ("decode") call on
    ``inp`` equals the same kernel's partials (same plan) merged by the
    standalone lse_merge_kernel, bit for bit: the last split block's merge
    and the standalone kernel run one routine over the same slots in the
    same order."""
    from repro_torch.kernels import paged_attention as PA
    DA = importlib.import_module("repro_torch.kernels.decode_attention")
    if kind == "paged":
        got = PA.paged_decode_attention(*inp)
        parts = PA.paged_decode_partials(*inp)
    else:
        plan = DA.plan_for(inp[0], inp[1])
        got = DA._launch(*inp, plan)
        parts = DA._launch(*inp, plan, partials=True)
    two = PA.lse_merge_partials(*parts, got.dtype)
    torch.cuda.synchronize()
    check(torch.equal(got, two),
          f"{name}: one launch differs from partials + merge by up to "
          f"{(got.float() - two.float()).abs().max().item():.3e}")


def compare(torch, PA, name, inputs, tol):
    one_launch_equal(torch, name, "paged", inputs)
    return close(torch, name, PA.paged_decode_attention(*inputs),
                 PA.paged_decode_attention_plain(*inputs), tol)


def time_ms(torch, fn, flush, n=30):
    """Mean device time of fn over n launches, CUDA events around each
    launch, the 50 MB L2 flushed before each (the engine finds the pool
    cold: every layer has its own). A spin kernel of about 1 ms is queued
    ahead of each timed call, so the device is still busy while the host
    enqueues the call: the events then time the device's work, not the
    host's launch gaps (which made short calls read up to 2.8x slower on a
    slower host)."""
    for _ in range(3):
        fn()
    total = 0.0
    for _ in range(n):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        total += a.elapsed_time(b)
    return total / n


def instantiation(name):
    """(dtype, G, D) of a mangled <T, G, D> kernel name, else its tail."""
    import re
    m = re.search(r"I(f|13__nv_bfloat16)Li(\d+)ELi(\d+)E", name)
    if not m:
        return name[-24:]
    return f"{'f32' if m[1] == 'f' else 'bf16'} G{m[2]} D{m[3]}"


def ptxas_lines(lib, kernel):
    """Print what ``-Xptxas -v`` reported for the instantiations of
    ``kernel`` in library ``lib``: their register range, and every one
    that spills."""
    from repro_torch.kernels import build
    log = build.library_path(lib).with_suffix(".log")
    if not log.exists():            # built by an earlier process
        print(f"ptxas: {lib}: no log beside the library")
        return
    name, regs, spills = None, [], []
    for line in log.read_text().splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif name and kernel in name and "Used" in line:
            regs.append(int(line.split("Used")[1].split()[0]))
        elif name and kernel in name and "spill stores" in line \
                and not line.split("bytes stack frame, ")[1].startswith("0 "):
            spills.append(f"{instantiation(name)}: "
                          f"{line.split(', ', 1)[1].strip()}")
    which = f": {'; '.join(spills)}" if spills else ""
    print(f"ptxas: {lib}: {kernel}: {len(regs)} instantiations, "
          f"{min(regs, default=0)}-{max(regs, default=0)} registers/thread, "
          f"{len(spills)} spill{which}")


def kernel_phase(torch, PA):
    torch.manual_seed(0)
    worst = {}
    # every built instantiation, small ragged case
    for dt, tol in ((torch.float32, F32), (torch.bfloat16, BF16)):
        for G in PA.GROUPS:
            for i, D in enumerate(PA.HEAD_DIMS):
                PS = (8, 16, 32)[(G + i) % 3]
                KH = 2
                inp = paged_inputs(torch, 3, G * KH, KH, PS, 4, D, dt,
                                   [1, PS + 3, 4 * PS], seed=G * 100 + D)
                e = compare(torch, PA, f"paged {dt} G{G} D{D} PS{PS}", inp,
                            tol)
                worst[str(dt)] = max(worst.get(str(dt), 0.0), e)
                # splits of more tiles than the cp.async ring has stages:
                # B * KH 400 plans one split a row, 200 two; 9+ tiles a row
                B, KH, PS = (50, 25)[i % 2], 8, 16
                tile = PA.tile_tokens(dt, D)
                P = 2 * -(-9 * tile // (2 * PS))
                lens = torch.randint(1, P * PS + 1, (B,)).tolist()
                lens[:3] = [P * PS, 0, P * PS // 2 + 1]
                inp = paged_inputs(torch, B, G * KH, KH, PS, P, D, dt, lens,
                                   seed=G * 100 + D + 1)
                n_splits, pps = PA.plan_for(*inp[:2], inp[3])
                check(pps * PS > 3 * tile, f"paged {dt} G{G} D{D}: splits "
                      f"of {pps} pages do not wrap the ring")
                e = compare(torch, PA, f"paged {dt} G{G} D{D} ring "
                            f"{n_splits} splits", inp, tol)
                worst[str(dt)] = max(worst.get(str(dt), 0.0), e)
    print(f"kernel: all {2 * len(PA.GROUPS) * len(PA.HEAD_DIMS)} "
          f"(dtype, G, D) instantiations agree with the plain version, on "
          f"short rows and on splits that wrap the stage ring; max err f32 "
          f"{worst['torch.float32']:.3e}, bf16 {worst['torch.bfloat16']:.3e}")
    # the JAX package's paged cases (tests/test_kernels.py), f32
    cases = [(3, 8, 2, 16, 4, 64), (2, 4, 4, 8, 6, 32),
             (1, 16, 8, 32, 3, 128)]
    for j, (B, H, KH, PS, P, D) in enumerate(cases):
        lens = torch.randint(1, PS * P + 1, (B,)).tolist()
        e = compare(torch, PA, f"PAGED_CASES[{j}]",
                    paged_inputs(torch, B, H, KH, PS, P, D, torch.float32,
                                 lens, seed=j), F32)
        print(f"kernel: PAGED_CASES[{j}] B{B} H{H} KH{KH} PS{PS} P{P} D{D} "
              f"lens={lens} max_err={e:.3e}")
    for j, lens in enumerate([[3, 16, 21, 64], [1, 8, 48, 63],
                              [16, 32, 5, 17]]):
        e = compare(torch, PA, f"PAGED_EDGE_LENS[{j}]",
                    paged_inputs(torch, 4, 8, 2, 16, 4, 32, torch.float32,
                                 lens, seed=10 + j), F32)
        print(f"kernel: PAGED_EDGE_LENS[{j}] lens={lens} max_err={e:.3e}")

    # main-path shapes: full smollm-360m decode half, bf16 pool. 128-page
    # rows (context 2048) at B 1, 8, 32; the serve phase's shape (8 decode
    # lanes, 64-page rows, prompts of 341 + up to 8 tokens); the host-tier
    # phase's (1 lane, 64-page rows, 768 + 32 + 4 tokens); the speculative
    # phase's target buckets (2 and 4 lanes, 341 + 32 tokens) and its
    # draft's decode steps (8 lanes, the last 3 masked) and the dummy
    # decode lane of each propose (masked). A masked lane is what the
    # draft makes of a lane whose budget is spent: an all-zero page-table
    # row and pos 0, so it reads (len 1) and writes the scratch page's
    # slot 0; the draft's live rows hold only their own pages, zeros past
    # them, as the engine builds them. Then mistral-7b's width (G 4, D
    # 128): 8 lanes of 64-page rows (its phase's max context 1024), lens
    # ragged up to 1024.
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    rows = []
    smollm = ("smollm-360m", 15, 5, 64)
    for B, P, max_len, masked in ((1, 128, 2048, 0), (8, 128, 2048, 0),
                                  (32, 128, 2048, 0), (8, 64, 349, 0),
                                  (1, 64, 804, 0), (2, 64, 373, 0),
                                  (4, 64, 373, 0), (8, 64, 376, 3),
                                  (1, 64, 1, 1)):
        rows.append(paged_row(torch, PA, flush, smollm, B, P, max_len,
                              masked))
    rows.append(paged_row(torch, PA, flush, ("mistral-7b", 32, 8, 128), 8,
                          64, 1024, 0))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for r in rows:
        blocks, regs, smem, tile = PA.occupancy(
            torch.bfloat16, r["H"] // r["KH"], r["D"], r["pages_per_split"])
        print(f"kernel: occupancy bf16 G{r['H'] // r['KH']} D{r['D']} "
              f"B{r['B']} P{r['P']}: "
              f"{r['n_splits']} splits of {r['pages_per_split']} pages "
              f"({tile}-token tiles), grid {r['grid_blocks']} blocks on "
              f"{sms} SMs; {blocks} resident blocks/SM x 128 threads, {regs} "
              f"registers/thread, {smem} B dynamic shared; one launch a "
              "call (the last split block of each (lane, head) merges)")
    ptxas_lines("paged_attention", "paged_split_kernel")
    ptxas_lines("paged_attention", "lse_merge_kernel")
    return rows


def paged_row_inputs(torch, width, B, P, max_len, masked, PS=16):
    """(name, inputs) of one main-path shape of the paged kernel: lens
    drawn up to ``max_len`` (the first lane full, the second at a page
    boundary), the last ``masked`` lanes masked as the draft masks a lane
    (an all-zero page-table row, len 1), live rows zero past their pages,
    bf16 pool. ``width``: (model, H, KH, D). Also read by
    time_split_merge.py."""
    model, H, KH, D = width
    rng = torch.Generator().manual_seed(B * P)
    lens = torch.randint(1, max_len + 1, (B,), generator=rng)
    lens[0] = max_len
    if B > 2:
        lens[1] = 16 * (max_len // 64)       # page-exact boundary
    if masked:
        lens[B - masked:] = 1
    lens = lens.tolist()
    inp = paged_inputs(torch, B, H, KH, PS, P, D, torch.bfloat16, lens,
                       seed=1000 + B)
    if masked:
        pt = inp[3]
        for b, n in enumerate(lens):
            pt[b, 0 if b >= B - masked else -(-n // PS):] = 0
    name = f"paged main path {model} B{B} P{P} len<={max_len}" + (
        f" ({masked} masked)" if masked else "")
    return name, inp


def paged_row(torch, PA, flush, width, B, P, max_len, masked, PS=16):
    """One main-path shape of the paged kernel (``paged_row_inputs``), as
    ``paged_timed`` holds and times it."""
    name, inp = paged_row_inputs(torch, width, B, P, max_len, masked, PS)
    return paged_timed(torch, PA, flush, width[0], name, inp, masked)


# the standalone merge's timed rows: (model, H, KH, D) of smollm-360m's
# slot-wise TP merge (G 3, D 64), mistral-7b (G 4, D 128) and
# mixtral-8x22b (G 6, D 128) at 8 lanes, and the slot counts of the main
# path's plans (PERF.md §6: 10 smollm serve, 16 smollm TP 2 and smollm
# B 1, 32 the masked dummy lane, about 50 the dense plan at B 1)
MERGE_WIDTHS = (("smollm-360m", 15, 5, 64), ("mistral-7b", 32, 8, 128),
                ("mixtral-8x22b", 48, 8, 128))
MERGE_SLOTS = (8, 10, 16, 32, 50)


def merge_partials(torch, g, B, KH, n, G, D):
    """f32 partials on the card, acc [B, KH, n, G, D], m and l [B, KH, n,
    G], about a fifth of the slots empty (m -inf, l 0, acc 0) as splits
    past a lane's end leave them."""
    acc = torch.randn(B, KH, n, G, D, generator=g, device="cuda")
    m = 3 * torch.randn(B, KH, n, G, generator=g, device="cuda")
    l = 1 + 50 * torch.rand(B, KH, n, G, generator=g, device="cuda")
    empty = torch.rand(B, KH, n, G, generator=g, device="cuda") < 0.2
    m[empty], l[empty] = float("-inf"), 0.0
    acc[empty] = 0.0
    return acc, m, l


def merge_phase(torch, PA, flush, B=8):
    """The standalone merge (``lse_merge_partials``: one launch of
    lse_merge_kernel, one warp a row) at MERGE_SLOTS x MERGE_WIDTHS, bf16
    and float32 output: held against its plain version, then timed beside
    its bound (the partials read once, the output written once) and a
    launch floor, a one-element torch.add timed the same way right before
    it: a lone launch cannot come near a bound of 0.08-3 microseconds
    (0.3-10 MB of partials), and the floor says how close it can come.
    Also read by time_split_merge.py for any tree."""
    from repro_torch.analysis import counting
    g = torch.Generator(device="cuda").manual_seed(11)
    one, dst = torch.ones(1, device="cuda"), torch.empty(1, device="cuda")
    rows = []
    for model, H, KH, D in MERGE_WIDTHS:
        G = H // KH
        for n in MERGE_SLOTS:
            acc, m, l = merge_partials(torch, g, B, KH, n, G, D)
            for dt, tol in ((torch.bfloat16, BF16), (torch.float32, F32)):
                name = f"merge {model} {n} slots {str(dt)[6:]}"
                err = close(torch, name, PA.lse_merge_partials(acc, m, l, dt),
                            PA.lse_merge_partials_plain(acc, m, l, dt), tol)
                out_bytes = B * H * D * (2 if dt == torch.bfloat16 else 4)
                b_ms, b_by = counting.bound_ms(
                    (acc.numel() + 2 * m.numel()) * 4 + out_bytes, 0)
                floor_ms = time_ms(
                    torch, lambda: torch.add(one, one, out=dst), flush)
                row = dict(
                    kernel="lse_merge_partials", width=model,
                    dtype=str(dt)[6:], B=B, H=H, KH=KH, G=G, D=D, slots=n,
                    max_abs_err=err,
                    ms=time_ms(torch, lambda: PA.lse_merge_partials(
                        acc, m, l, dt), flush),
                    plain_ms=time_ms(torch, lambda: PA.
                                     lse_merge_partials_plain(acc, m, l, dt),
                                     flush, n=10),
                    library_ms=None, bound_ms=b_ms, bound_by=b_by,
                    launch_floor_ms=floor_ms)
                print("merge: " + json.dumps(row))
                rows.append(row)
    return rows


def paged_timed(torch, PA, flush, model, name, inp, masked):
    """The paged kernel on ``inp`` (q, bf16 pools, page table, lens) held
    against the plain version, then kernel, plain version and SDPA on the
    pre-gathered KV timed beside the bound; ``masked``: the lanes with an
    all-zero (scratch) page-table row."""
    from repro_torch.analysis import counting
    err = compare(torch, PA, name, inp, BF16)
    q, k, v, pt, ln = inp
    B, H, D = q.shape
    PS, KH = k.shape[1], k.shape[2]
    P = pt.shape[1]
    lens = ln.tolist()
    n_splits, pps = PA.plan_for(q, k, pt)
    S = P * PS
    idx = pt.long()
    kg = k[idx].reshape(B, S, KH, D).permute(0, 2, 1, 3).contiguous()
    vg = v[idx].reshape(B, S, KH, D).permute(0, 2, 1, 3).contiguous()
    mask = (torch.arange(S, device="cuda")[None, :]
            < ln[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]
    gqa = {}
    if tuple(int(x) for x in torch.__version__.split(".")[:2]) >= (2, 5):
        gqa = {"enable_gqa": True}
    else:                       # no GQA in SDPA: repeat the KV heads
        kg = kg.repeat_interleave(H // KH, dim=1)
        vg = vg.repeat_interleave(H // KH, dim=1)

    def library():
        return torch.nn.functional.scaled_dot_product_attention(
            q4, kg, vg, attn_mask=mask, **gqa)
    lib_out = library()[:, :, 0]
    check(bool(((lib_out.float() - PA.paged_decode_attention_plain(
        *inp).float()).abs() <= 2e-2).all()),
        f"{name}: library yardstick disagrees")
    kernel_ms = time_ms(torch, lambda: PA.paged_decode_attention(*inp),
                        flush)
    plain_ms = time_ms(torch,
                       lambda: PA.paged_decode_attention_plain(*inp),
                       flush)
    library_ms = time_ms(torch, library, flush)
    ntok = sum(lens)
    kv_bytes = ntok * KH * D * 2 * 2
    other = (2 * B * H * D * 2 + B * 4
             + sum(math.ceil(n / PS) for n in lens) * 4)
    b_ms, b_by = counting.bound_ms(kv_bytes + other, 4 * ntok * H * D)
    row = dict(width=model, H=H, KH=KH, D=D, B=B, P=P, masked=masked,
               lens_max=max(lens), tokens=ntok,
               max_abs_err=err, ms=kernel_ms, plain_ms=plain_ms,
               library_ms=library_ms, bound_ms=b_ms, bound_by=b_by,
               hbm_frac=b_ms / kernel_ms,
               n_splits=n_splits, pages_per_split=pps,
               grid_blocks=n_splits * B * KH)
    print("kernel: main path " + json.dumps(row))
    return row


# ---------------------------------------------------------------------------
# the kernel library: split-K decode, shared-prefix decode, causal flash
# ---------------------------------------------------------------------------

def rand(torch, g, dtype, *shape):
    return torch.randn(*shape, generator=g, device="cuda").to(dtype)


def ragged(torch, g, n, hi):
    """n lengths in [1, hi], the first hi (one full lane)."""
    lens = torch.randint(1, hi + 1, (n,), generator=g, device="cuda")
    lens[0] = hi
    return lens.to(torch.int32)


def full_width_cases(torch, seed=3):
    """The library calls timed at full head widths, bf16, random tensors
    from ``seed`` (the same inputs whatever ran before): flash causal B 1
    S 2048 (smollm-360m: H 15 / KH 5, D 64) and S 8192 with the 4096 window
    (mistral-7b: H 32 / KH 8, D 128); decode B 8 over S 2048 / 8192 with
    ragged lens (one full lane); shared-prefix decode B 32, prefix 4096,
    suffixes <= 256. Each with the bytes its function must move (inputs
    read once, outputs written once, only the valid KV of ragged lanes)
    and its flops (4 D per visible (query, key) pair). Also read by
    tools/time_launches.py."""
    from repro_torch.analysis import counting
    g = torch.Generator(device="cuda").manual_seed(seed)
    bf = torch.bfloat16
    widths = (("smollm-360m", 15, 5, 64), ("mistral-7b", 32, 8, 128))
    cases = []
    for (width, H, KH, D), (S, win) in zip(widths, ((2048, 0), (8192, 4096))):
        q, k, v = (rand(torch, g, bf, 1, H, S, D),
                   rand(torch, g, bf, 1, KH, S, D),
                   rand(torch, g, bf, 1, KH, S, D))
        cases.append(dict(kind="flash", width=width, B=1, H=H, KH=KH, D=D,
                          window=win, args=(q, k, v),
                          bytes=2 * (2 * q.numel() + 2 * k.numel()),
                          flops=4 * D * H * counting.visible_pairs(
                              S, S, True, win)))
    for (width, H, KH, D), S in zip(widths, (2048, 8192)):
        B = 8
        q = rand(torch, g, bf, B, H, D)
        k, v = rand(torch, g, bf, B, KH, S, D), rand(torch, g, bf, B, KH, S, D)
        lens = ragged(torch, g, B, S)
        ntok = int(lens.sum())
        cases.append(dict(kind="decode", width=width, B=B, H=H, KH=KH, D=D,
                          args=(q, k, v, lens),
                          bytes=ntok * KH * D * 2 * 2 + 2 * q.numel() * 2
                          + B * 4, flops=4 * ntok * H * D))
    for width, H, KH, D in widths:
        B, Sp, Ss = 32, 4096, 256
        q = rand(torch, g, bf, B, H, D)
        kp, vp = rand(torch, g, bf, KH, Sp, D), rand(torch, g, bf, KH, Sp, D)
        ks, vs = (rand(torch, g, bf, B, KH, Ss, D),
                  rand(torch, g, bf, B, KH, Ss, D))
        lens = ragged(torch, g, B, Ss)
        ntok = int(lens.sum())
        cases.append(dict(kind="prefix", width=width, B=B, H=H, KH=KH, D=D,
                          args=(q, kp, vp, ks, vs, lens),
                          bytes=2 * KH * Sp * D * 2 + ntok * KH * D * 2 * 2
                          + 2 * q.numel() * 2 + B * 4,
                          flops=4 * H * D * (B * Sp + ntok)))
    return cases


def measure_row(torch, out, flush, kind, width, kernel, plain, library,
                bytes_, flops, plain_n=10, library_n=30):
    """Hold ``kernel()`` against ``plain()`` (bf16 bound) and the
    yardstick ``library()`` against it too, then time all three beside
    the bound of ``bytes_`` and ``flops``; the row is printed and kept in
    ``out[kind]``."""
    from repro_torch.analysis import counting
    err = close(torch, f"{kind} {width}", kernel(), plain(), BF16)
    # the yardstick may round P to bf16 before P V: a looser bound,
    # still tight enough to catch a wrong mask
    lib_err = close(torch, f"{kind} {width} yardstick", library(),
                    plain(), dict(atol=5e-2, rtol=0.0))
    b_ms, b_by = counting.bound_ms(bytes_, flops)
    row = dict(width=width, max_abs_err=err, library_err=lib_err,
               ms=time_ms(torch, kernel, flush),
               plain_ms=time_ms(torch, plain, flush, n=plain_n),
               library_ms=time_ms(torch, library, flush, n=library_n),
               bound_ms=b_ms, bound_by=b_by, bytes=bytes_, flops=flops)
    row["bound_frac"] = b_ms / row["ms"]
    print(f"library: {kind} " + json.dumps(row))
    out.setdefault(kind, []).append(row)
    return row


def library_phase(torch, bench, DA, PF, FA):
    """bench: the library's benchmark entry point; DA, PF, FA: the
    decode, prefix and flash kernel modules. Returns the launch counts of
    bench.run and the full-width rows for the JSON line."""
    from repro_torch.kernels.checks import GROUPS, HEAD_DIMS
    sdpa = torch.nn.functional.scaled_dot_product_attention
    dec, dec_plain = DA.decode_attention, DA.decode_attention_plain
    pre, pre_plain = PF.prefix_attention, PF.prefix_attention_plain
    part, part_plain = PF.prefix_partial, PF.prefix_partial_plain
    fla, fla_plain = FA.flash_attention, FA.flash_attention_plain

    # 1. the slice's main path: the library's bench.run, counts from 0
    dec.launches = part.launches = fla.launches = 0
    t0 = time.perf_counter()
    printed = io.StringIO()        # its JSON rows, prefixed below: the
    with contextlib.redirect_stdout(printed):  # result lines stay last
        rows = bench.run(device="cuda")
    wall = time.perf_counter() - t0
    for line in printed.getvalue().splitlines():
        print(f"library: bench {line}")
    launches = {"decode": dec.launches, "prefix": part.launches,
                "flash": fla.launches}
    for kind, n in launches.items():
        want = sum(r["kernel"] == kind for r in rows)
        check(n > 0 and n == want,
              f"bench.run: {kind} kernel launched {n} times for {want} rows")
    print(f"library: bench.run(device='cuda') {len(rows)} rows all ok in "
          f"{wall:.2f}s, max err "
          f"{max(r['max_err'] for r in rows):.3e}; launches {launches}")

    # 2. every built instantiation, then the JAX package's cases (f32)
    g = torch.Generator(device="cuda").manual_seed(0)
    worst = {}
    for dt, tol in ((torch.float32, F32), (torch.bfloat16, BF16)):
        for D in HEAD_DIMS:
            # 6 key tiles of 64: more than the bf16 path's 4 ring stages
            q, k, v = (rand(torch, g, dt, 2, 4, 300, D),
                       rand(torch, g, dt, 2, 2, 330, D),
                       rand(torch, g, dt, 2, 2, 330, D))
            for causal, win, kv_len in ((True, 0, None), (False, 0, None),
                                        (True, 200, None), (True, 24, 311),
                                        (False, 0, 290)):
                e = close(torch, f"flash {dt} D{D} c{causal} w{win}",
                          fla(q, k, v, causal=causal, window=win,
                              kv_len=kv_len),
                          fla_plain(q, k, v, causal=causal, window=win,
                                    kv_len=kv_len), tol)
                worst[("flash", dt)] = max(worst.get(("flash", dt), 0), e)
            for G in GROUPS:
                KH = 2
                q = rand(torch, g, dt, 3, G * KH, D)
                k, v = (rand(torch, g, dt, 3, KH, 300, D),
                        rand(torch, g, dt, 3, KH, 300, D))
                lens = torch.tensor([1, 150, 300], dtype=torch.int32,
                                    device="cuda")
                e = close(torch, f"decode {dt} G{G} D{D}",
                          dec(q, k, v, lens, n_splits=4),
                          dec_plain(q, k, v, lens, n_splits=4), tol)
                one_launch_equal(torch, f"decode {dt} G{G} D{D}", "decode",
                                 (q, k, v, lens))
                worst[("decode", dt)] = max(worst.get(("decode", dt), 0), e)
                # 400 (lane, head) pairs: 7 tiles a row plan one split (the
                # block writes q's dtype), 9 tiles two splits of 5 (merged);
                # either wraps the 3-stage ring
                tile = DA.tile_tokens(dt, D)
                for n_tiles in (7, 9):
                    S = n_tiles * tile
                    q = rand(torch, g, dt, 50, G * 8, D)
                    k, v = (rand(torch, g, dt, 50, 8, S, D),
                            rand(torch, g, dt, 50, 8, S, D))
                    lens = torch.randint(1, S + 1, (50,), generator=g,
                                         device="cuda").to(torch.int32)
                    lens[:3] = torch.tensor([S, 1, 0])
                    ns, split_len = DA.plan_for(q, k)
                    check(split_len > 3 * tile and ns == (n_tiles > 7) + 1,
                          f"decode {dt} G{G} D{D}: plan {ns} x {split_len} "
                          "does not wrap the ring")
                    e = close(torch, f"decode {dt} G{G} D{D} ring {ns} splits",
                              dec(q, k, v, lens), dec_plain(q, k, v, lens),
                              tol)
                    one_launch_equal(torch, f"decode {dt} G{G} D{D} ring",
                                     "decode", (q, k, v, lens))
                    worst[("decode", dt)] = max(worst.get(("decode", dt), 0),
                                                e)
                # B * G folded rows: <= 64 (4 rows a thread), <= 128 (8),
                # > 128 (two row tiles)
                for B in (2, -(-65 // G), -(-129 // G)):
                    q = rand(torch, g, dt, B, G * KH, D)
                    kp, vp = (rand(torch, g, dt, KH, 200, D),
                              rand(torch, g, dt, KH, 200, D))
                    ks, vs = (rand(torch, g, dt, B, KH, 40, D),
                              rand(torch, g, dt, B, KH, 40, D))
                    sl = ragged(torch, g, B, 40)
                    e = close(torch, f"prefix {dt} G{G} D{D} B{B}",
                              pre(q, kp, vp, ks, vs, sl, block_k=64),
                              pre_plain(q, kp, vp, ks, vs, sl), tol)
                    worst[("prefix", dt)] = max(worst.get(("prefix", dt), 0),
                                                e)
                    partial_close(torch, f"prefix {dt} G{G} D{D} B{B} partial",
                                  part(q, kp, vp, block_k=64), q, kp, vp,
                                  part_plain)
    print("library: every instantiation agrees with its plain version "
          "(flash dtype x D x 5 masks, decode dtype x G x D, prefix dtype x "
          "G x D x 3 row counts); max err " + ", ".join(
              f"{k} {str(d)[6:]} {e:.3e}" for (k, d), e in worst.items()))
    f32 = torch.float32
    for j, (B, H, KH, Sq, Skv, D, causal, win) in enumerate(bench.FLASH_CASES):
        q, k, v = (rand(torch, g, f32, B, H, Sq, D),
                   rand(torch, g, f32, B, KH, Skv, D),
                   rand(torch, g, f32, B, KH, Skv, D))
        e = close(torch, f"FLASH_CASES[{j}]",
                  fla(q, k, v, causal=causal, window=win),
                  fla_plain(q, k, v, causal=causal, window=win), F32)
        print(f"library: FLASH_CASES[{j}] {bench.FLASH_CASES[j]} "
              f"max_err={e:.3e}")
    for j, (B, H, KH, S, D, ns) in enumerate(bench.DEC_CASES):
        q, k, v = (rand(torch, g, f32, B, H, D),
                   rand(torch, g, f32, B, KH, S, D),
                   rand(torch, g, f32, B, KH, S, D))
        lens = ragged(torch, g, B, S)
        e = close(torch, f"DEC_CASES[{j}]", dec(q, k, v, lens, n_splits=ns),
                  dec_plain(q, k, v, lens, n_splits=ns), F32)
        print(f"library: DEC_CASES[{j}] {bench.DEC_CASES[j]} max_err={e:.3e}")
    for j, (B, H, KH, Sp, Ss, D) in enumerate(bench.PRE_CASES):
        q = rand(torch, g, f32, B, H, D)
        kp, vp = (rand(torch, g, f32, KH, Sp, D),
                  rand(torch, g, f32, KH, Sp, D))
        ks, vs = (rand(torch, g, f32, B, KH, Ss, D),
                  rand(torch, g, f32, B, KH, Ss, D))
        lens = ragged(torch, g, B, Ss)
        e = close(torch, f"PRE_CASES[{j}]", pre(q, kp, vp, ks, vs, lens),
                  pre_plain(q, kp, vp, ks, vs, lens), F32)
        partial_close(torch, f"PRE_CASES[{j}] partial", part(q, kp, vp), q,
                      kp, vp, part_plain)
        print(f"library: PRE_CASES[{j}] {bench.PRE_CASES[j]} max_err={e:.3e} "
              "(and prefix_partial's raw acc, m, l)")

    # 3. full widths, bf16: kernel, plain version and a PyTorch yardstick
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    bf = torch.bfloat16
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {}
    measure = functools.partial(measure_row, torch, out, flush)
    for case in full_width_cases(torch):
        kind, width, args = case["kind"], case["width"], case["args"]
        B, H, D = case["B"], case["H"], case["D"]
        KH = case["KH"]
        if kind == "flash":
            q, k, v = args
            win, S = case["window"], q.shape[2]
            if win:
                pos = torch.arange(S, device="cuda")
                mask = (pos[None, :] <= pos[:, None]) \
                    & (pos[None, :] > pos[:, None] - win)

                def library(q=q, k=k, v=v, mask=mask):
                    return sdpa(q, k, v, attn_mask=mask, enable_gqa=True)
            else:
                def library(q=q, k=k, v=v):
                    return sdpa(q, k, v, is_causal=True, enable_gqa=True)
            measure("flash", width,
                    lambda a=args, w=win: fla(*a, window=w),
                    lambda a=args, w=win: fla_plain(*a, window=w),
                    library, case["bytes"], case["flops"],
                    plain_n=3 if win else 10, library_n=10 if win else 30)
        elif kind == "decode":
            q, k, v, lens = args
            S = k.shape[2]
            one_launch_equal(torch, f"decode {width}", "decode", args)
            mask = (torch.arange(S, device="cuda")[None, :]
                    < lens[:, None])[:, None, None, :]
            measure("decode", width,
                    lambda a=args: dec(*a, n_splits=8),
                    lambda a=args: dec_plain(*a, n_splits=8),
                    lambda q=q, k=k, v=v, m=mask: sdpa(
                        q[:, :, None], k, v, attn_mask=m,
                        enable_gqa=True)[:, :, 0],
                    case["bytes"], case["flops"])
            ns, split_len = DA.plan_for(q, k)
            blocks, regs, smem, tile = DA.occupancy(bf, H // KH, D)
            print(f"library: decode plan {width} B{B} S{S}: {ns} splits of "
                  f"{split_len} keys ({tile}-key tiles), grid {ns * KH * B} "
                  f"blocks on {sms} SMs, one launch a call; {blocks} "
                  f"resident blocks/SM x 128 threads, {regs} "
                  f"registers/thread, {smem} B dynamic shared")
        else:
            q, kp, vp, ks, vs, lens = args
            Sp, Ss = kp.shape[1], ks.shape[2]
            # the yardstick's inputs: each request's [prefix ++ suffix],
            # built here and not timed; SDPA then reads the prefix B times
            kc = torch.cat([kp[None].expand(B, -1, -1, -1), ks], dim=2)
            vc = torch.cat([vp[None].expand(B, -1, -1, -1), vs], dim=2)
            mask = (torch.arange(Sp + Ss, device="cuda")[None, :]
                    < (Sp + lens)[:, None])[:, None, None, :]
            measure("prefix", width,
                    lambda a=args: pre(*a), lambda a=args: pre_plain(*a),
                    lambda q=q, kc=kc, vc=vc, m=mask: sdpa(
                        q[:, :, None], kc, vc, attn_mask=m,
                        enable_gqa=True)[:, :, 0],
                    case["bytes"], case["flops"])
            (n_pre, chunk), (n_sfx, sfx_len) = PF.plan_for(q, kp, ks)
            blocks, regs, smem, threads = PF.occupancy(bf, D, B * H // KH)
            tiles = -(-B * H // KH // 128)
            print(f"library: prefix plan {width} B{B} Sp{Sp} Ss{Ss}: prefix "
                  f"{n_pre} splits of {chunk} keys x {tiles} row tiles x {KH} "
                  f"KV heads = {n_pre * tiles * KH} blocks on {sms} SMs "
                  f"({blocks} resident blocks/SM x {threads} threads, {regs} "
                  f"registers/thread, {smem} B shared); suffix {n_sfx} "
                  f"splits of {sfx_len} keys = {n_sfx * KH * B} blocks "
                  f"beside the prefix half (on a second stream); merge of "
                  f"{n_pre + n_sfx} slots; 3 launches a call")

    for G, D in ((3, 64), (4, 128)):
        blocks, regs, smem, threads = FA.occupancy(bf, D)
        KH, S = (5, 2048) if G == 3 else (8, 8192)
        gh = FA.head_group(G)
        pos = 128 // gh
        print(f"library: occupancy flash bf16 D{D} G{G} (wgmma, {gh} "
              f"heads x {pos} positions a block): {blocks} resident "
              f"blocks/SM x {threads} threads, {regs} registers/thread, "
              f"{smem} B shared; grid {-(-S // pos)} x {KH * G // gh} = "
              f"{-(-S // pos) * KH * G // gh} blocks on {sms} SMs")
    for lib, kernel in (("flash_attention", "flash_wgmma_kernel"),
                        ("decode_attention", "dense_split_kernel"),
                        ("prefix_attention", "prefix_wgmma_kernel"),
                        ("prefix_attention", "dense_split_kernel")):
        ptxas_lines(lib, kernel)
    return launches, out


# ---------------------------------------------------------------------------
# the main path: full-width serve
# ---------------------------------------------------------------------------

def serve_phase(torch, PA, serve):
    args = serve.parse_args(SERVE_ARGS)
    torch.cuda.reset_peak_memory_stats()
    PA.paged_decode_attention.launches = 0
    replays = []
    with tap_graph_replays(replays):
        res = serve.run(args)
    launches = PA.paged_decode_attention.launches
    serve.report(args, res)
    cl, cfg = res["cluster"], res["cfg"]
    check(cfg.n_layers == 32 and cfg.d_model == 960 and cfg.n_heads == 15
          and cfg.n_kv_heads == 5 and cfg.vocab_size == 49152
          and cfg.dtype == "bfloat16", "serve did not run at full width")
    check(len(res["done"]) == 16 and all(
        r.state.value == "finished" for r in res["done"]),
        f"finished {len(res['done'])}/16")
    for r in res["done"]:
        check(len(r.output_tokens) == r.max_new_tokens
              and all(0 <= t < cfg.vocab_size for t in r.output_tokens),
              f"request {r.request_id}: bad outputs {r.output_tokens}")
    engines = list(cl.engines.values())
    reused = sum(e.stats["reused_tokens"] for e in engines)
    check(reused > 0, "no prefix reuse")
    tok = res["params"]["embed"]["tok"]
    check(tok.is_cuda, "params not on the card")
    for e in engines:
        check(e.params["embed"]["tok"].is_cuda, "engine params not on card")
        check(all(kv[n].is_cuda for g in e.pages.values()
                  for kv in g.values() for n in ("k", "v")),
              "pool not on the card")
    dispatches = sum(e.stats["model_dispatches"] for e in engines)
    iters = sum(e.stats["iterations"] for e in engines)
    check(launches > 0, "the paged decode kernel never launched")
    check(launches == cfg.n_layers * dispatches,
          f"kernel launches {launches} != {cfg.n_layers} x "
          f"{dispatches} model dispatches")
    n_replays = sum(e.stats["decode_graph_replays"] for e in engines)
    check(n_replays == len(replays) and n_replays == sum(
        e.stats["model_dispatches"] - e.stats["fused_iterations"]
        for e in engines),
        f"serve: {n_replays} replays, {len(replays)} tapped, not every "
        "pure-decode dispatch")
    check(n_replays > 0, "serve: no pure-decode step was replayed")
    graphs = {}
    for i, e in cl.engines.items():
        mine = {id(g) for g in e._graphs.graphs.values()}
        own = [r for r in replays if id(r[0]) in mine]
        if own:
            graphs[i] = hold_replays(torch, PA, e, own,
                                     {"decode": [], "paged": []},
                                     f"serve instance {i}")
    replays.clear()
    wall = res["wall"]
    out = dict(wall_s=wall, engine_steps=iters, steps_per_s=iters / wall,
               model_dispatches=dispatches, kernel_launches=launches,
               decode_graphs=graphs,
               reused_tokens=reused,
               prefilled_tokens=sum(e.stats["prefilled_tokens"]
                                    for e in engines),
               decode_steps=sum(e.stats["decode_steps"] for e in engines),
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    print("serve: " + json.dumps(out))
    return launches


# ---------------------------------------------------------------------------
# the host KV tier and speculative decoding at full width
# ---------------------------------------------------------------------------

# videoqa/loogle-style thrash (benchmarks/bench_offload.py), engine-sized:
# 6 shared 768-token prefixes, each with a unique 32-token tail and 4 new
# tokens, in 3 interleaved rounds (each round's 6 requests arrive at once).
# Each instance's pool holds 1664 tokens, ~35 % of the 4800-token working
# set: one request in flight (804 tokens) plus one 768-token prefetched
# chain, but not the 3 prefixes E2 gives it, so every re-hit finds its
# prefix demoted. One request in flight per instance, so the rest of a
# round waits with room in the pool: the head of the queue is prefetched
# while the instance serves another, the first of a round restores at
# admission. (At 1280 tokens a waiting request never has the 768 free
# tokens a prefetch needs.) The host tier holds 5120 tokens.
TIER = dict(n_prefixes=6, prefix_len=768, tail_len=32, out=4, rounds=3,
            round_gap=1.0)
TIER_ECONF = dict(max_context=1024, chunk_size=64, max_batch_tokens=256,
                  max_batch_requests=1, capacity_tokens=1664, page_size=16)
TIER_HOST = dict(host_capacity_tokens=5120, prefetch_budget_tokens=1024)


def tier_requests(torch, Request, vocab, seed=0):
    g = torch.Generator().manual_seed(seed)
    t = TIER
    prefixes = [tuple(torch.randint(1, vocab, (t["prefix_len"],),
                                    generator=g).tolist())
                for _ in range(t["n_prefixes"])]
    reqs = []
    for i in range(t["rounds"]):
        for pref in prefixes:
            tail = torch.randint(1, vocab, (t["tail_len"],), generator=g)
            reqs.append(Request(tokens=pref + tuple(tail.tolist()),
                                max_new_tokens=t["out"],
                                arrival_time=i * t["round_gap"]))
    return reqs


def drive(torch, PA, cl, reqs):
    """cl.run on the card with the paged kernel's count at 0; returns
    (wall seconds after the device finished, kernel launches)."""
    torch.cuda.synchronize()
    PA.paged_decode_attention.launches = 0
    t0 = time.perf_counter()
    cl.run(reqs, dt=0.01)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, PA.paged_decode_attention.launches


def check_outputs(name, reqs, vocab):
    check(all(r.state.value == "finished" for r in reqs),
          f"{name}: {sum(r.state.value == 'finished' for r in reqs)}/"
          f"{len(reqs)} finished")
    for r in reqs:
        check(len(r.output_tokens) == r.max_new_tokens
              and all(0 <= t < vocab for t in r.output_tokens),
              f"{name}: request {r.request_id}: bad outputs "
              f"{r.output_tokens}")


def link_rates(torch, cfg, reps=5):
    """The host link alone, beside the phase's copies: one pinned copy
    of a span of the full-width pool (every leaf: n_layers x K and V,
    [tokens, KH, D] bf16) each way on an otherwise idle card, CUDA events
    around it; GB/s, mean of ``reps``, for a 768-token span (what the
    phase moves) and a 1024-token one."""
    out = {}
    for n in (768, 1024):
        shape = (2 * cfg.n_layers, n, cfg.n_kv_heads, cfg.head_dim)
        host = torch.zeros(shape, dtype=torch.bfloat16, pin_memory=True)
        dev = torch.zeros(shape, dtype=torch.bfloat16, device="cuda")
        for name, dst, src in (("h2d", dev, host), ("d2h", host, dev)):
            dst.copy_(src, non_blocking=True)          # warm
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            torch.cuda.synchronize()
            ev[0].record()
            for _ in range(reps):
                dst.copy_(src, non_blocking=True)
            ev[1].record()
            ev[1].synchronize()
            ms = ev[0].elapsed_time(ev[1]) / reps
            out[f"{name}_{n}_gb_s"] = host.nbytes / ms / 1e6
    return out


def host_tier_phase(torch, PA, cfg, params, ClusterRuntime, EngineConfig,
                    Request):
    out = {}
    for tier in (True, False):
        econf = EngineConfig(**TIER_ECONF, **(TIER_HOST if tier else {}))
        cl = ClusterRuntime(cfg, params, num_instances=2, engine_cfg=econf,
                            device="cuda")
        reqs = tier_requests(torch, Request, cfg.vocab_size)
        logs = [e.attach_copy_log() for e in cl.engines.values()]
        wall, launches = drive(torch, PA, cl, reqs)
        check_outputs("host tier" if tier else "no tier", reqs,
                      cfg.vocab_size)
        cl.check_invariants()
        engines = list(cl.engines.values())
        st = {k: sum(e.stats[k] for e in engines)
              for k in ("prefilled_tokens", "reused_tokens",
                        "model_dispatches", "iterations", "demoted_tokens",
                        "restored_tokens", "restore_dispatches",
                        "prefetch_issued", "prefetch_hit",
                        "demote_batches", "demote_batches_overlapped",
                        "prefetch_batches", "prefetch_batches_overlapped")}
        check(launches == cfg.n_layers * st["model_dispatches"],
              f"host tier: kernel launches {launches} != {cfg.n_layers} x "
              f"{st['model_dispatches']} model dispatches")
        if not tier:
            out["no_tier"] = dict(wall_s=wall, steps=st["iterations"],
                                  prefilled_tokens=st["prefilled_tokens"],
                                  reused_tokens=st["reused_tokens"])
            continue
        for k in ("demoted_tokens", "restored_tokens", "restore_dispatches",
                  "prefetch_issued"):
            check(st[k] > 0, f"host tier: {k} is 0")
        copies = [log.fold(block=True) for log in logs]
        c = {k: sum(x[k] for x in copies) for k in copies[0]}
        out.update(
            wall_s=wall, steps=st["iterations"], kernel_launches=launches,
            demoted_tokens=st["demoted_tokens"],
            restored_tokens=st["restored_tokens"],
            prefetched_tokens=st["prefetch_issued"],
            prefetch_hit_tokens=st["prefetch_hit"],
            prefilled_tokens=st["prefilled_tokens"],
            reused_tokens=st["reused_tokens"],
            migrated_tokens=cl.stats["migrated_tokens"],
            d2h_bytes=c["d2h_bytes"], d2h_copies=c["d2h_copies"],
            d2h_ms=c["d2h_ms"],
            d2h_gb_s=c["d2h_bytes"] / c["d2h_ms"] / 1e6,
            h2d_bytes=c["h2d_bytes"], h2d_copies=c["h2d_copies"],
            h2d_ms=c["h2d_ms"],
            h2d_gb_s=c["h2d_bytes"] / c["h2d_ms"] / 1e6,
            drain_blocked_s=c["drain_blocked_s"],
            drain_blocked_share=c["drain_blocked_s"] / wall,
            demote_overlap_frac=(st["demote_batches_overlapped"]
                                 / max(st["demote_batches"], 1)),
            prefetch_overlap_frac=(st["prefetch_batches_overlapped"]
                                   / max(st["prefetch_batches"], 1)))
    out["link"] = link_rates(torch, cfg)
    check(out["no_tier"]["prefilled_tokens"] > out["prefilled_tokens"],
          f"host tier: prefilled {out['prefilled_tokens']} tokens, not "
          f"fewer than {out['no_tier']['prefilled_tokens']} without it")
    print("host_tier: " + json.dumps(out))


SPEC_K, DRAFT_LAYERS = 4, 4
SPEC_ECONF = dict(max_context=1024, chunk_size=64, max_batch_tokens=256,
                  capacity_tokens=8192, page_size=16)


def spec_pair(torch, cfg, params):
    """benchmarks/bench_spec.py's calibrated pair at full width: the
    target's attention wo and FFN wd are zero in layers DRAFT_LAYERS..,
    so those layers are identities on the residual; the draft is the
    same config at DRAFT_LAYERS layers with the target's first layers."""
    import dataclasses
    check(set(params["stack"]) == {"p0"}, "expected a uniform layer plan")
    p0 = params["stack"]["p0"]
    wo, wd = p0["attn"]["wo"].clone(), p0["ffn"]["wd"].clone()
    wo[DRAFT_LAYERS:] = 0
    wd[DRAFT_LAYERS:] = 0
    tp0 = {**p0, "attn": {**p0["attn"], "wo": wo},
           "ffn": {**p0["ffn"], "wd": wd}}

    def head(tree):
        if isinstance(tree, dict):
            return {k: head(v) for k, v in tree.items()}
        return tree[:DRAFT_LAYERS]

    target = {"embed": params["embed"], "stack": {"p0": tp0}}
    draft = {"embed": params["embed"], "stack": {"p0": head(tp0)}}
    return target, dataclasses.replace(cfg, n_layers=DRAFT_LAYERS), draft


def spec_requests(Request, gen_workload, vocab):
    """8 toolbench prompts cut to a third of the context (as the serve
    CLI scales them), 32 new tokens each, all arriving at once."""
    n = SPEC_ECONF["max_context"] // 3
    return [Request(tokens=tuple(t % vocab for t in r.tokens[:n]),
                    max_new_tokens=32, workload=r.workload)
            for r in gen_workload("toolbench", 8, seed=0)]


def spec_phase(torch, PA, cfg, params, ClusterRuntime, EngineConfig,
               Request, SpeculativeConfig, gen_workload):
    target, dcfg, dparams = spec_pair(torch, cfg, params)
    out = {}
    for on in (False, True):
        spec = (SpeculativeConfig(draft_cfg=dcfg, k=SPEC_K,
                                  draft_params=dparams) if on else None)
        cl = ClusterRuntime(cfg, target, num_instances=1, device="cuda",
                            engine_cfg=EngineConfig(**SPEC_ECONF,
                                                    speculative=spec))
        reqs = spec_requests(Request, gen_workload, cfg.vocab_size)
        eng = cl.engines[0]
        draft_s = [0.0]
        if on:
            # host wall of the draft's propose calls (each ends in a
            # device sync): the draft's share of the run
            propose = eng.draft.propose

            def timed(lanes):
                t0 = time.perf_counter()
                out = propose(lanes)
                draft_s[0] += time.perf_counter() - t0
                return out
            eng.draft.propose = timed
        wall, launches = drive(torch, PA, cl, reqs)
        name = "spec on" if on else "spec off"
        check_outputs(name, reqs, cfg.vocab_size)
        cl.check_invariants()
        st = eng.stats
        check(st["model_dispatches"] == st["iterations"],
              f"{name}: {st['model_dispatches']} target dispatches in "
              f"{st['iterations']} iterations")
        n_tok = sum(len(r.output_tokens) for r in reqs)
        row = dict(wall_s=wall, iterations=st["iterations"],
                   wall_per_iteration_ms=1e3 * wall / st["iterations"],
                   output_tokens=n_tok, tokens_per_s=n_tok / wall,
                   kernel_launches=launches)
        want = cfg.n_layers * st["model_dispatches"]
        if on:
            d = eng.draft
            check(st["spec_draft_dispatches"] > 0, "no draft dispatch")
            check(not d.pool.tables, f"leaked draft tables "
                  f"{list(d.pool.tables)}")
            d.pool.check_invariants()
            want += dcfg.n_layers * (d.dispatches + d.decode_steps)
            row.update(acceptance=st["spec_acceptance_frac"],
                       draft_propose_s=draft_s[0],
                       proposed_tokens=st["spec_proposed_tokens"],
                       accepted_tokens=st["spec_accepted_tokens"],
                       verify_lanes=st["spec_verify_lanes"],
                       draft_dispatches=d.dispatches,
                       draft_decode_steps=d.decode_steps,
                       degraded=st["spec_degraded"])
        check(launches == want,
              f"{name}: kernel launches {launches} != {want} (target "
              f"{cfg.n_layers} x dispatches + draft layers x forwards)")
        out["on" if on else "off"] = row
    out["speedup_tokens_per_s"] = (out["on"]["tokens_per_s"]
                                   / out["off"]["tokens_per_s"])
    print("speculative: " + json.dumps(out))


# mistral-7b, the paper's primary model, at full width on both data
# planes: 8 toolbench prompts cut to a third of the context (as the serve
# CLI scales them), each the shared head (the first MISTRAL_HEAD tokens of
# the system prompt) and the last 41 - 4 i tokens of its own question, so
# no two lanes hold the same tokens and their lens are ragged (341 down
# to 313); 8 new tokens each; the first 2 run to completion before the
# other 6 arrive, so the prefix store holds the head and the 6 reuse it
# on either plane.
MISTRAL_ECONF = dict(max_context=1024, chunk_size=64, max_batch_tokens=256,
                     page_size=16, capacity_tokens=16384)
MISTRAL_HEAD = 300


def mistral_requests(Request, gen_workload, vocab):
    return [Request(tokens=tuple(t % vocab for t in r.tokens[:MISTRAL_HEAD]
                                 + r.tokens[-(41 - 4 * i):]),
                    max_new_tokens=8, workload=r.workload)
            for i, r in enumerate(gen_workload("toolbench", 8, seed=0))]


def serve_waves(eng, reqs, first=2, max_iters=5000):
    """Step one engine through reqs[:first], then the rest; returns the
    engine steps taken."""
    now, done, steps = 0.0, [], 0
    for wave in (reqs[:first], reqs[first:]):
        for r in wave:
            eng.scheduler.enqueue(r, now)
        target = len(done) + len(wave)
        while len(done) < target and steps < max_iters:
            done += eng.step(now)
            now += 0.01
            steps += 1
    check(len(done) == len(reqs), f"{len(done)}/{len(reqs)} finished")
    return steps


@contextlib.contextmanager
def tap_decode_kernels(torch, per_dispatch, served):
    """While open, the model's calls of the split-K decode and paged
    kernels go straight through to their wrappers (whose launch counts
    stay their own). A dispatch makes ``per_dispatch`` calls of a kernel
    (0: none, and nothing is tapped); of them the first call with each
    cache shape has its inputs kept in ``served[kind]`` ("decode",
    "paged"): q's shape, the cache's ([B, KH, S, D] view or [N, PS, KH, D]
    pool) shape, the page table (None for decode) and lens, cloned on the
    device without a wait. Every call of one shape in a dispatch gets the
    same lanes (a VLM's self- and cross-attention calls differ in
    shape)."""
    from repro_torch.models import attention as A
    orig = {"decode": A._split_k_decode, "paged": A.paged_decode_attention}
    calls = dict.fromkeys(orig, 0)
    seen = {kind: set() for kind in orig}

    def tapped(kind):
        def call(q, k, v, *rest):
            if calls[kind] % per_dispatch == 0:
                seen[kind].clear()
            if tuple(k.shape) not in seen[kind]:
                seen[kind].add(tuple(k.shape))
                pt = rest[0].clone() if kind == "paged" else None
                served[kind].append((tuple(q.shape), tuple(k.shape), pt,
                                     rest[-1].clone()))
            calls[kind] += 1
            return orig[kind](q, k, v, *rest)
        return call
    if per_dispatch:
        A._split_k_decode, A.paged_decode_attention = (tapped("decode"),
                                                       tapped("paged"))
    try:
        yield
    finally:
        A._split_k_decode = orig["decode"]
        A.paged_decode_attention = orig["paged"]
    for kind, n in calls.items():
        check(n % max(per_dispatch, 1) == 0,
              f"{kind}: {n} calls are not {per_dispatch} a dispatch")


@contextlib.contextmanager
def tap_graph_replays(replays):
    """While open, each replay of a pure-decode CUDA graph
    (``serving/decode_graph.py``) keeps (its graph, a clone of its static
    inputs, made on the device without a wait) in ``replays``."""
    from repro_torch.serving import decode_graph as DG
    orig = DG.DecodeGraphs.__dict__["replay"]

    def replay(g):
        replays.append((g, g.inputs.clone()))
        return orig.__func__(g)
    DG.DecodeGraphs.replay = staticmethod(replay)
    try:
        yield
    finally:
        DG.DecodeGraphs.replay = orig


def hold_replays(torch, PA, eng, replays, served, name):
    """Hold the graphs a served engine replayed against its eager forward
    at the engine's width. Every replay in ``replays``
    (``tap_graph_replays``) runs again on its inputs under torch.profiler,
    which has to see one launch of the paged split kernel a layer a
    replay (what a replay adds to the wrapper's count is not a launch).
    Then each runs again beside ``api.decode_paged`` on the same inputs,
    back to back on the pool as it is, the eager call's paged inputs
    kept in ``served["paged"]`` (``tap_decode_kernels``): the two give
    the same token on every lane. Returns the numbers checked."""
    from torch.profiler import ProfilerActivity, profile
    check(len(replays) > 0, f"{name}: no pure-decode step was replayed")
    n_layers, P = eng.model_cfg.n_layers, eng._pages_per_req
    launches0 = PA.paged_decode_attention.launches
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for g, inputs in replays:
            g.inputs.copy_(inputs)
            g.graph.replay()
        torch.cuda.synchronize()
    traced = sum(k[1] for k in device_kernels(torch, prof)
                 if "paged_split_kernel" in k[2])
    check(traced == n_layers * len(replays),
          f"{name}: {len(replays)} replays launched the paged split kernel "
          f"{traced} times in the device trace, not {n_layers} a replay")
    lanes = differ = 0
    with torch.no_grad(), tap_decode_kernels(torch, n_layers, served):
        for g, inputs in replays:
            Bb = g.out.shape[0]
            g.inputs.copy_(inputs)
            g.graph.replay()
            got = g.out.clone()
            # the packed decode batch: tokens, positions, page table (the
            # chunk half is empty)
            want, _ = eng.api.decode_paged(
                eng.params, eng.pages,
                {"tokens": inputs[:Bb], "pos": inputs[Bb:2 * Bb],
                 "page_table": inputs[2 * Bb:].view(Bb, P)})
            lanes += Bb
            differ += int((got != want).sum())
    PA.paged_decode_attention.launches = launches0
    check(differ == 0, f"{name}: replayed tokens differ from the eager "
          f"forward's on {differ} of {lanes} lanes")
    return dict(replays=len(replays), lanes=lanes,
                paged_split_launches_traced=traced)


def served_shapes(torch, DA, PA, flush, served, model):
    """Hold each kernel against its plain version on every input the
    main path gave it (``tap_decode_kernels``): the same shapes, lens and
    page tables, random bf16 q and KV; then time the last input of each
    lane count (and, for split-K, cache length) beside its bound, its
    plain version and SDPA. Returns {kind: [(lane count, inputs, timed
    row)]}."""
    g = torch.Generator(device="cuda").manual_seed(7)
    bf = torch.bfloat16
    rows = {}
    for kind, calls in served.items():
        last = {}
        for qs, ks, pt, lens in calls:
            B, H, D = qs
            q = rand(torch, g, bf, *qs)
            if kind == "paged":
                k, v = rand(torch, g, bf, *ks), rand(torch, g, bf, *ks)
                inp = (q, k, v, pt, lens)
                masked = int((pt == 0).all(1).sum())
                compare(torch, PA, f"paged served {model} B{B} "
                        f"lens {lens.tolist()}", inp, BF16)
            else:
                KH, S = ks[1], ks[2]
                # the model layout [B, S, KH, D], read through views
                k = rand(torch, g, bf, B, S, KH, D).transpose(1, 2)
                v = rand(torch, g, bf, B, S, KH, D).transpose(1, 2)
                inp = (q, k, v, lens)
                masked = 0
                close(torch, f"decode served {model} B{B} "
                      f"lens {lens.tolist()}", DA.decode_attention(*inp),
                      DA.decode_attention_plain(*inp), BF16)
                one_launch_equal(torch, f"decode served {model} B{B}",
                                 "decode", inp)
            key = (B, ks[2]) if kind == "decode" else (B,)
            n = last.get(key, (0,))[0]
            last[key] = (n + 1, inp, masked)
        counts = {k: c[0] for k, c in sorted(last.items())}
        print(f"{model}: {kind} kernel held against its plain version on "
              f"all {len(calls)} served inputs (by lane count"
              f"{' and cache length' if kind == 'decode' else ''}: "
              f"{counts})")
        for key, (n, inp, masked) in sorted(last.items()):
            B = key[0]
            if kind == "paged":
                row = paged_timed(torch, PA, flush, model,
                                  f"paged served {model} B{B}", inp, masked)
            else:
                row = decode_row(torch, DA, flush,
                                 f"{model} dense serve B{B} S{key[1]}", inp)
            rows.setdefault(kind, []).append((B, n, row))
    return rows


def decode_row(torch, DA, flush, label, inp):
    """Time the split-K decode kernel on ``inp`` = (q [B, H, D], k / v
    [B, KH, S, D] views, lens [B]) beside its plain version, SDPA masked
    to the lens and the bound of the valid KV bytes (``measure_row``)."""
    q, k, v, lens = inp
    S, KH = k.shape[2], k.shape[1]
    ntok = int(lens.sum())
    mask = (torch.arange(S, device="cuda")[None, :]
            < lens[:, None])[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    row = measure_row(
        torch, {}, flush, "decode_served", label,
        lambda a=inp: DA.decode_attention(*a),
        lambda a=inp: DA.decode_attention_plain(*a),
        lambda q=q, k=k, v=v, m=mask: sdpa(
            q[:, :, None], k, v, attn_mask=m, enable_gqa=True)[:, :, 0],
        ntok * KH * q.shape[2] * 2 * 2 + 2 * q.numel() * 2
        + q.shape[0] * 4, 4 * ntok * q.shape[1] * q.shape[2])
    ns, split_len = DA.plan_for(q, k)
    row.update(B=q.shape[0], S=S, H=q.shape[1], KH=KH, D=q.shape[2],
               lens=lens.tolist(), n_splits=ns, split_len=split_len)
    return row


def mistral_phase(torch, DA, PA, cfg, zoo, Engine, EngineConfig, Request,
                  gen_workload):
    """Serve mistral-7b once on the automatic plane (paged fused: the
    engine removes the window, as the reference's does) and once with
    paged=False; the split-K decode kernel serves the dense plane's
    decode, the paged kernel the paged plane's. Each kernel is then held
    against its plain version on every input its plane gave it."""
    check(cfg.n_layers == 32 and cfg.d_model == 4096 and cfg.n_heads == 32
          and cfg.n_kv_heads == 8 and cfg.head_dim == 128
          and cfg.d_ff == 14336 and cfg.vocab_size == 32000
          and cfg.sliding_window == 4096 and cfg.dtype == "bfloat16",
          "mistral-7b is not at full width")
    from repro_torch.serving.kv_offload import tree_leaves
    t0 = time.perf_counter()
    params = zoo.build(cfg).init(
        torch.Generator(device="cuda").manual_seed(0), "cuda")
    torch.cuda.synchronize()
    out = dict(init_s=time.perf_counter() - t0,
               param_gib=sum(t.numel() * t.element_size()
                             for _, t in tree_leaves(params)) / 2 ** 30)
    outputs = {}
    served = {"decode": [], "paged": []}
    for plane, paged in (("auto", None), ("dense", False)):
        eng = Engine(cfg, params, EngineConfig(**MISTRAL_ECONF, paged=paged),
                     device="cuda")
        reqs = mistral_requests(Request, gen_workload, cfg.vocab_size)
        check(len(set(r.tokens for r in reqs)) == len(reqs),
              "mistral requests are not distinct")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        DA.decode_attention.launches = PA.paged_decode_attention.launches = 0
        replays = []
        with tap_decode_kernels(torch, cfg.n_layers, served), \
                tap_graph_replays(replays):
            t0 = time.perf_counter()
            steps = serve_waves(eng, reqs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        split_k = DA.decode_attention.launches
        paged_l = PA.paged_decode_attention.launches
        name = f"mistral {plane}"
        check_outputs(name, reqs, cfg.vocab_size)
        st = eng.stats
        check(st["reused_tokens"] > 0, f"{name}: no prefix reuse")
        if eng.paged:
            check(split_k == 0, f"{name}: split-K decode launched {split_k} "
                  "times on the paged plane")
            check(paged_l > 0 and paged_l == cfg.n_layers
                  * st["model_dispatches"],
                  f"{name}: paged kernel launches {paged_l} != "
                  f"{cfg.n_layers} x {st['model_dispatches']} dispatches")
        else:
            check(paged_l == 0, f"{name}: paged kernel launched {paged_l} "
                  "times on the dense plane")
            check(split_k > 0 and split_k == cfg.n_layers
                  * st["decode_batches"],
                  f"{name}: split-K decode launches {split_k} != "
                  f"{cfg.n_layers} x {st['decode_batches']} decode batches")
        reused, prefilled = st["reused_tokens"], st["prefilled_tokens"]
        out[plane] = dict(
            paged=eng.paged, steps=steps, model_dispatches=st[
                "model_dispatches"], decode_batches=st["decode_batches"],
            cache_concat_calls=st["cache_concat_calls"],
            reused_tokens=reused, prefilled_tokens=prefilled,
            reuse_share=reused / (reused + prefilled), wall_s=wall,
            steps_per_s=steps / wall,
            peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
            paged_decode_launches=paged_l, split_k_decode_launches=split_k)
        check(len(replays) == st["decode_graph_replays"] == (
            st["model_dispatches"] - st["fused_iterations"]
            if eng.paged else 0),
            f"{name}: {len(replays)} replays tapped, "
            f"{st['decode_graph_replays']} counted")
        if eng.paged:
            out[plane]["decode_graphs"] = hold_replays(
                torch, PA, eng, replays, served, name)
        replays.clear()
        outputs[plane] = [list(r.output_tokens) for r in reqs]
        del eng
    # bf16 with two reduction orders: reported, not gated
    out.update(agreement(outputs))
    out["request0_tokens"] = {k: v[0] for k, v in outputs.items()}
    out["dense_profile"] = dense_profile(torch, DA, cfg, params, Engine,
                                         EngineConfig, Request, gen_workload)
    print("mistral: " + json.dumps(out))
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    out["served"] = served_shapes(torch, DA, PA, flush, served, "mistral-7b")
    t0 = time.perf_counter()
    out["tp"] = mistral_tp_phase(torch, DA, PA, cfg, params, Engine,
                                 EngineConfig, Request, gen_workload, flush)
    print(f"tp: mistral-7b TP 1/2/4 took {time.perf_counter() - t0:.1f}s")
    out["simulator"] = simulator_phase(torch, PA, cfg, params, Engine,
                                       EngineConfig, Request)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# the cluster simulator's cost model, fitted to the engine
# ---------------------------------------------------------------------------

# One engine on the automatic plane (paged fused) whose batching is the
# simulator's (SimConfig's chunk 512 and 4096 tokens an iteration), so one
# engine step is one simulated iteration. The pool holds every prompt
# the profile admits (~96k tokens), so no step evicts.
SIM_ECONF = dict(max_context=4352, chunk_size=512, max_batch_tokens=4096,
                 max_batch_requests=32, page_size=16, capacity_tokens=131072)
SIM_PREFILL = (1, 2, 4, 8)          # distinct prompts admitted in one step
SIM_DECODE = (1, 2, 4, 8, 16, 32)   # decode lanes of a decode-only step
SIM_PROMPT = 512                    # prefill prompts: one chunk each
SIM_CTX = 1008                      # decode prompts; contexts 1008-1032
SIM_REPS = 3                        # timed prefill steps a shape
SIM_STEPS = 8                       # timed decode steps a lane count
SIM_GEN = 24                        # new tokens of a decode request
SIM_TRACE = (("prefill", 8), ("decode", 8))     # one profiled step each
# benchmarks/bench_e2e.py's quick grid (n = max(n // 2, 60), its middle
# rate), each rate also taken 2, 4 and 8 times
FIG3_GRID = {"toolbench": (150, 8.0), "agent": (150, 8.0),
             "programming": (100, 4.0), "videoqa": (100, 2.0),
             "loogle": (75, 1.0)}
FIG3_MULTIPLIERS = (1, 2, 4, 8)


def timed_step(torch, eng, now, dev):
    """One ``eng.step(now)`` between two synchronizes, timed by the host
    clock; its composition is read from the engine's stats deltas."""
    st = eng.stats
    before = (st["prefilled_tokens"], st["decode_steps"],
              st["reused_tokens"])
    sync(torch, dev)
    t0 = time.perf_counter()
    done = eng.step(now)
    sync(torch, dev)
    wall = time.perf_counter() - t0
    return done, dict(wall=wall,
                      prefilled=st["prefilled_tokens"] - before[0],
                      decoded=st["decode_steps"] - before[1],
                      reused=st["reused_tokens"] - before[2])


def traced_step(torch, step):
    """``step()`` (a ``timed_step``) under torch.profiler, device activity
    only: its result, and the device busy share of its wall, its kernel
    launches and its costliest kernels. Instrumentation only: the fit's
    samples are unprofiled steps."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        done, rec = step()
    kernels = device_kernels(torch, prof)
    busy_ms = sum(k[0] for k in kernels) / 1e3
    rec.update(device_busy_ms=busy_ms,
               device_busy_share=busy_ms / (rec["wall"] * 1e3),
               launches=sum(k[1] for k in kernels),
               top=[dict(kernel=k[2][:60], ms=k[0] / 1e3, calls=k[1])
                    for k in kernels[:6]])
    return done, rec


def profile_engine(torch, eng, Request, vocab, dev, prefill=SIM_PREFILL,
                   decode=SIM_DECODE, prompt=SIM_PROMPT, ctx=SIM_CTX,
                   reps=SIM_REPS, steps=SIM_STEPS, gen=SIM_GEN, trace=(),
                   seed=0):
    """The paper's offline profiling (App. B) on one engine: timed steps
    of known composition. Prefill: ``k`` distinct ``prompt``-token
    prompts admitted together (k x prompt prefill tokens, no decode
    lane), ``reps`` times a k after one warm-up step; each batch then
    finishes in one untimed decode step. Decode: ``L`` distinct
    ``ctx``-token prompts, prefilled untimed, then the first ``steps``
    decode-only steps with all L lanes after one warm-up. Every prompt
    starts with its own token, so nothing is reused. ``trace`` ((kind,
    k or L), ...) adds one more such step of that shape under
    torch.profiler (``traced_step``), outside the samples. Returns the
    fit's samples (prefill: (tokens, seconds); decode: (lanes,
    seconds)), a record of every sampled step (kind, size, wall,
    composition, decode contexts), the traced steps and the model
    dispatches the profile made."""
    rng = random.Random(seed)
    first = iter(range(1, vocab))
    trace = dict(trace)

    def prompts(n, length):
        return [Request(tokens=(next(first),) + tuple(
            rng.randrange(1, vocab) for _ in range(length - 1)),
            max_new_tokens=1) for _ in range(n)]

    out = dict(prefill=[], decode=[], records=[], traces={})
    dispatches = eng.stats["model_dispatches"]
    clock = [0.0]

    def step(traced=False):
        def run():
            done = timed_step(torch, eng, clock[0], dev)
            clock[0] += 0.01
            return done
        return traced_step(torch, run) if traced else run()

    for k in prefill:
        check(k * prompt <= eng.econf.max_batch_tokens,
              f"profile: {k} x {prompt} tokens exceed a step")
        for rep in range(reps + 1 + (trace.get("prefill") == k)):
            for r in prompts(k, prompt):
                eng.scheduler.enqueue(r, clock[0])
            done, rec = step(traced=rep > reps)
            check(rec["prefilled"] == k * prompt and rec["decoded"] == 0
                  and rec["reused"] == 0 and not done,
                  f"profile: prefill step of {k} prompts ran {rec}")
            if rep > reps:
                out["traces"]["prefill"] = dict(x=k * prompt, **rec)
            elif rep:
                out["prefill"].append((k * prompt, rec["wall"]))
                out["records"].append(dict(kind="prefill", x=k * prompt,
                                           **rec))
            done, rec = step()
            check(len(done) == k and rec["decoded"] == k
                  and rec["prefilled"] == 0,
                  f"profile: {k} one-token requests did not finish")
    for lanes in decode:
        reqs = prompts(lanes, ctx)
        for r in reqs:
            r.max_new_tokens = gen
            eng.scheduler.enqueue(r, clock[0])
        full, finished = 0, 0
        while finished < lanes:
            ctxs = [r.prompt_len + len(r.output_tokens) for r in reqs]
            traced = trace.get("decode") == lanes and full == steps + 1
            done, rec = step(traced)
            finished += len(done)
            if traced:
                check(rec["prefilled"] == 0 and rec["decoded"] == lanes,
                      f"profile: the traced {lanes}-lane step ran {rec}")
                out["traces"]["decode"] = dict(x=lanes,
                                               ctx=sum(ctxs) / lanes, **rec)
            if rec["prefilled"] == 0 and rec["decoded"] == lanes:
                if 0 < full <= steps:
                    out["decode"].append((lanes, rec["wall"]))
                    out["records"].append(dict(
                        kind="decode", x=lanes,
                        ctx=sum(ctxs) / lanes, **rec))
                full += 1
        check(full > steps + (trace.get("decode") == lanes),
              f"profile: {lanes} lanes ran {full} decode-only steps")
        check(all(r.state.value == "finished" for r in reqs),
              f"profile: a {lanes}-lane request did not finish")
    out["dispatches"] = eng.stats["model_dispatches"] - dispatches
    return out


def coefficients(cm):
    return {k: getattr(cm, k) for k in ("prefill_a", "prefill_b",
                                        "decode_a", "decode_b")}


def fig3_grid(S, cost_models, gen_workload, poisson_arrivals,
              assign_arrivals, grid=FIG3_GRID, multipliers=FIG3_MULTIPLIERS,
              instances=4):
    """benchmarks/bench_e2e.py's Figure 3 runs through the port's
    simulator module ``S``: each workload of ``grid`` at each multiple of
    its rate, E2 and round-robin on ``instances`` instances (workload seed
    3, arrival seed 7), under each of ``cost_models`` ({label:
    CostModel}, put in place of ``S.cost_model_for``). Every request must
    finish and none fail, and the simulator's invariants hold after each
    run. Returns one row a (label, workload, multiplier)."""
    import copy
    from unittest import mock
    rows = []
    for label, cm in cost_models.items():
        def model_for(model, chips=1, cm=cm):
            check(model == cm.model.name and chips == 1,
                  f"fig3: a {model} x {chips} cost model was asked for")
            return copy.deepcopy(cm)
        with mock.patch.object(S, "cost_model_for", model_for):
            for wl, (n, rps) in grid.items():
                for m in multipliers:
                    times = poisson_arrivals(n, rps * m, seed=7)
                    res = {}
                    for pol in ("e2", "rr"):
                        reqs = assign_arrivals(gen_workload(wl, n, seed=3),
                                               times)
                        sim = S.Simulator(S.SimConfig(
                            num_instances=instances, policy=pol))
                        got = sim.run(reqs)
                        check(len(got.finished) == n and not got.failed,
                              f"fig3 {label} {wl} x{m} {pol}: "
                              f"{len(got.finished)}/{n} finished, "
                              f"{len(got.failed)} failed")
                        sim.check_invariants()
                        res[pol] = got.summary()
                    e2, rr = res["e2"], res["rr"]
                    rows.append(dict(
                        model=label, workload=wl, n=n, rps=rps * m, mult=m,
                        **{f"{p}_{k}": res[p][key] for p in ("e2", "rr")
                           for k, key in (("avg", "avg_latency"),
                                          ("p99", "p99_latency"),
                                          ("ttft", "avg_ttft"),
                                          ("hit", "cache_hit_frac"))},
                        rr_over_e2_avg=rr["avg_latency"] / e2["avg_latency"],
                        rr_over_e2_p99=rr["p99_latency"]
                        / e2["p99_latency"]))
    return rows


def simulator_phase(torch, PA, cfg, params, Engine, EngineConfig, Request,
                    dev="cuda"):
    """Profile one engine as the paper's App. B profiles its GPUs, fit
    the cost model (``CostModel.fit``) to the samples, and run the
    paper's Figure 3 grid through the port's simulator under the
    data-sheet and the fitted model. Checks the paged kernel's launches
    (layers x dispatches), the fit's samples and coefficients, and that
    every simulated request finished with the invariants holding; the
    E2 / round-robin ratios are reported."""
    from repro_torch.core.cost_model import cost_model_for
    from repro_torch.data import (assign_arrivals, gen_workload,
                                  poisson_arrivals)
    from repro_torch.serving import simulator as S
    t0 = time.perf_counter()
    eng = Engine(cfg, params, EngineConfig(**SIM_ECONF), device=dev)
    check(eng.paged and eng.fused, "simulator: the engine is not paged "
          "and fused")
    PA.paged_decode_attention.launches = 0
    prof = profile_engine(torch, eng, Request, cfg.vocab_size, dev,
                          trace=SIM_TRACE)
    launches = PA.paged_decode_attention.launches
    check(launches == cfg.n_layers * prof["dispatches"],
          f"simulator: paged kernel launches {launches} != {cfg.n_layers} "
          f"x {prof['dispatches']} dispatches")
    del eng
    gc.collect()
    profile_s = time.perf_counter() - t0
    check(len(prof["prefill"]) >= 4 and len(prof["decode"]) >= 6,
          f"simulator: {len(prof['prefill'])} prefill and "
          f"{len(prof['decode'])} decode samples")
    sheet = cost_model_for(cfg.name)
    fitted = cost_model_for(cfg.name)
    fitted.fit(prof["prefill"], prof["decode"])
    coef = {"sheet": coefficients(sheet), "fitted": coefficients(fitted)}
    check(all(math.isfinite(v) and v >= 0
              for v in coef["fitted"].values()),
          f"simulator: fitted coefficients {coef['fitted']}")
    print(f"simulator: profiled {len(prof['records'])} steps "
          f"({prof['dispatches']} dispatches, {launches} paged launches) in "
          f"{profile_s:.1f}s; coefficients " + json.dumps(coef))
    for rec in prof["records"]:
        if rec["kind"] == "prefill":
            args, fit = (rec["x"], 0), fitted.prefill_time(rec["x"])
        else:
            args, fit = (0, rec["x"], rec["ctx"]), fitted.decode_time(
                rec["x"])
        rec.update(sheet_s=sheet.batch_time(*args),
                   fitted_s=fitted.batch_time(*args),
                   residual_s=rec["wall"] - fit)
        print("simulator sample: " + json.dumps(rec))
    for kind, rec in prof["traces"].items():
        print(f"simulator trace {kind}: " + json.dumps(rec))
    t1 = time.perf_counter()
    rows = fig3_grid(S, {"sheet": sheet, "fitted": fitted}, gen_workload,
                     poisson_arrivals, assign_arrivals)
    grid_s = time.perf_counter() - t1
    for row in rows:
        print("simulator fig3: " + json.dumps(row))
    print(f"simulator: {2 * len(rows)} simulations in {grid_s:.1f}s; "
          f"phase took {time.perf_counter() - t0:.1f}s")
    return dict(coefficients=coef, records=prof["records"], fig3=rows,
                traces=prof["traces"], launches=launches)


def agreement(outputs):
    """Shares of output tokens, and of first output tokens, on which the
    paged and dense runs agree."""
    pairs = [(a, b) for x, y in zip(outputs["auto"], outputs["dense"])
             for a, b in zip(x, y)]
    firsts = [x[0] == y[0] for x, y in zip(outputs["auto"],
                                           outputs["dense"])]
    return dict(token_agreement=sum(a == b for a, b in pairs) / len(pairs),
                first_token_agreement=sum(firsts) / len(firsts))


def device_kernels(torch, prof):
    """(self device us, calls, name) of every device kernel in a
    torch.profiler trace, costliest first."""
    from torch.autograd import DeviceType
    kernels = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        kernels.append((us, e.count, e.key))
    return sorted(kernels, reverse=True)


def dense_profile(torch, DA, cfg, params, Engine, EngineConfig, Request,
                  gen_workload):
    """The dense run again under torch.profiler (device activity only):
    device busy share of the wall, the device time of the split-K decode
    kernel and of the cache concatenations; fails unless every split-K
    call was one launch of the split kernel and no merge kernel ran (its
    last split blocks merge). Instrumentation only: the phase's wall is
    the unprofiled run's."""
    from torch.profiler import ProfilerActivity, profile
    eng = Engine(cfg, params, EngineConfig(**MISTRAL_ECONF, paged=False),
                 device="cuda")
    reqs = mistral_requests(Request, gen_workload, cfg.vocab_size)
    torch.cuda.synchronize()
    calls0 = DA.decode_attention.launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        serve_waves(eng, reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    calls = DA.decode_attention.launches - calls0
    kernels = device_kernels(torch, prof)
    busy_ms = sum(k[0] for k in kernels) / 1e3
    check(busy_ms > 0.0, "dense profile: the profiler recorded no device "
          "time, so the launches a split-K call are not measured")

    def ms(*names):
        return sum(k[0] for k in kernels
                   if any(n in k[2] for n in names)) / 1e3

    def launched(name):
        return sum(k[1] for k in kernels if name in k[2])
    split_n, merge_n = launched("dense_split_kernel"), launched(
        "lse_merge_kernel")
    check(calls > 0 and split_n == calls and merge_n == 0,
          f"dense profile: {calls} split-K calls launched the split kernel "
          f"{split_n} times and the merge kernel {merge_n} times")
    split_ms = ms("dense_split_kernel")
    cat_ms = ms("CatArrayBatchedCopy")
    return dict(profiled_wall_s=wall, device_busy_ms=busy_ms,
                device_busy_share=busy_ms / (wall * 1e3),
                split_k_calls=calls, split_kernel_launches=split_n,
                merge_launches=merge_n,
                split_k_decode_ms=split_ms,
                split_k_decode_ms_per_call=split_ms / calls,
                split_k_decode_share_of_busy=split_ms / busy_ms,
                split_k_decode_share_of_wall=split_ms / (wall * 1e3),
                concat_ms=cat_ms, concat_share_of_busy=cat_ms / busy_ms,
                top=[dict(kernel=k[2][:60], ms=k[0] / 1e3, calls=k[1])
                     for k in kernels[:6]])


def profile_phase(torch, PA, serve):
    """Where the time goes: a second, smaller full-width serve (4
    requests) with torch.profiler (device activity only, to keep the
    trace small) over ``cl.run`` only. Reports the device busy share
    (kernel time / profiled wall), kernel launches per engine step and
    the kernels that take the most device time; fails unless every paged
    call was one launch of the split kernel and no merge kernel ran (the
    last split block of each (lane, head) merges). Instrumentation only:
    nothing here is the main path's measurement."""
    from torch.profiler import ProfilerActivity, profile
    args = serve.parse_args(SERVE_ARGS[:5] + ["4"] + SERVE_ARGS[6:])
    res = serve.setup(args)
    cl = res["cluster"]
    torch.cuda.synchronize()
    t_prof = time.perf_counter()
    PA.paged_decode_attention.launches = 0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        done = cl.run(res["requests"], dt=0.01)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    check(len(done) == 4, "profiled serve did not finish")
    steps = sum(e.stats["iterations"] for e in cl.engines.values())
    kernels = device_kernels(torch, prof)
    busy_ms = sum(k[0] for k in kernels) / 1e3
    check(busy_ms > 0.0, "profile: the profiler recorded no device time, "
          "so the launches a paged call are not measured")
    calls = PA.paged_decode_attention.launches
    paged = [k for k in kernels if "paged_split_kernel" in k[2]]
    merge = [k for k in kernels if "lse_merge_kernel" in k[2]]
    split_n, merge_n = sum(k[1] for k in paged), sum(k[1] for k in merge)
    check(calls > 0 and split_n == calls and merge_n == 0,
          f"profile: {calls} paged calls launched the split kernel "
          f"{split_n} times and the merge kernel {merge_n} times")
    paged_ms = sum(k[0] for k in paged) / 1e3
    out = dict(profiled_wall_s=wall,
               profiler_total_s=time.perf_counter() - t_prof,
               engine_steps=steps,
               device_busy_ms=busy_ms,
               device_busy_share=busy_ms / (wall * 1e3),
               kernel_launches_per_step=sum(k[1] for k in kernels) / steps,
               paged_decode=dict(
                   calls=calls, split_kernel_launches=split_n,
                   merge_launches=merge_n, device_ms=paged_ms,
                   device_ms_per_call=paged_ms / calls,
                   device_share=paged_ms / busy_ms),
               top=[dict(kernel=k[2][:60], ms=k[0] / 1e3, calls=k[1])
                    for k in kernels[:8]])
    print("profile: " + json.dumps(out))


def reference_phase(torch, configs, bridge, zoo, Engine, EngineConfig,
                    Request):
    """The engine on the card against the same engine on the CPU, small
    float32 configs, same parameters and stream, token-identical: reduced
    smollm-360m on the paged plane and on the dense one, reduced
    mistral-7b on the dense one (its decode: the split-K kernel at G 2,
    D 16); then zoo.prefill and 8 zoo.decode steps of reduced raw
    mistral-7b (window 16) past the window, its ring cache wrapping."""
    import dataclasses
    for arch, paged in (("smollm-360m", None), ("smollm-360m", False),
                        ("mistral-7b", False)):
        cfg = dataclasses.replace(configs.reduced(configs.ARCHS[arch]),
                                  n_layers=2, dtype="float32")
        engine_card_vs_cpu(torch, bridge, cfg, paged, Engine, EngineConfig,
                           Request)
    cfg = dataclasses.replace(configs.reduced(configs.ARCHS["mistral-7b"]),
                              dtype="float32")
    api = zoo.build(cfg)
    params = bridge.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.randint(1, cfg.vocab_size, (2, 40),
                         generator=torch.Generator().manual_seed(2))
    outs = {}
    for dev in ("cpu", "cuda"):
        p = bridge.tree_to(params, dev)
        nxt, cache = api.prefill(p, {"tokens": toks.to(dev)})
        check(cache["p0"]["k"].shape[2] == cfg.sliding_window == 16,
              f"raw mistral cache {tuple(cache['p0']['k'].shape)} is not "
              "a ring of the window")
        seq = [nxt.tolist()]
        for i in range(8):
            nxt, cache = api.decode(p, cache, {"tokens": nxt, "pos": 40 + i})
            seq.append(nxt.tolist())
        outs[dev] = seq
    check(outs["cuda"] == outs["cpu"],
          f"raw mistral prefill+decode: card {outs['cuda']} vs CPU "
          f"{outs['cpu']}")
    print("reference: reduced raw mistral-7b (window 16) prefill + 8 "
          "decode steps past the window on the card == on the CPU")


def engine_card_vs_cpu(torch, bridge, cfg, paged, Engine, EngineConfig,
                       Request, chips=1):
    """The engine on the card against the same engine on the CPU, same
    parameters and stream; ``chips`` > 1: a tensor-parallel engine, its
    shards on the one card (on the CPU: CPU shards), at the same device
    capacity. Returns the card's outputs."""
    params = bridge.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    gen = torch.Generator().manual_seed(1)
    shared = torch.randint(1, cfg.vocab_size, (29,), generator=gen).tolist()
    prompts = [tuple(shared + torch.randint(1, cfg.vocab_size, (8,),
                                            generator=gen).tolist())
               for _ in range(6)]
    outs = {}
    for dev in ("cpu", "cuda"):
        eng = Engine(cfg, params, EngineConfig(
            max_context=64, chunk_size=16, max_batch_tokens=64,
            capacity_tokens=4096 // chips, page_size=16, paged=paged,
            chips_per_instance=chips), device=dev,
            devices=tp_devices(chips) if dev == "cuda" else None)
        reqs = [Request(tokens=p, max_new_tokens=4) for p in prompts]
        now, done = 0.0, []
        for r in reqs[:2]:
            eng.scheduler.enqueue(r, now)
        while len(done) < 2:
            done += eng.step(now)
            now += 0.01
        for r in reqs[2:]:
            eng.scheduler.enqueue(r, now)
        while len(done) < len(reqs):
            done += eng.step(now)
            now += 0.01
        eng.pool.check_invariants()
        check(eng.stats["reused_tokens"] > 0, f"{dev}: no reuse")
        check(eng.paged == (paged is None), f"{dev}: wrong data plane")
        check((eng.mesh is None) == (chips == 1), f"{dev}: wrong submesh")
        outs[dev] = [list(r.output_tokens) for r in reqs]
    plane = "paged" if paged is None else "dense"
    if chips > 1:
        plane += f" tp{chips} ({eng.plan.pool}-wise pool)"
    check(outs["cuda"] == outs["cpu"],
          f"{cfg.name} {plane}: card and CPU engines disagree: "
          f"{outs['cuda']} vs {outs['cpu']}")
    print(f"reference: reduced float32 {cfg.name} engine, {plane} plane, on "
          f"the card == on the CPU, {len(prompts)} requests token-identical")
    return outs["cuda"]


def tp_reference_phase(torch, configs, bridge, Engine, EngineConfig,
                       Request):
    """Reduced float32 smollm-360m and mistral-7b (H 2, KH 1: slot-wise
    pools) on the paged plane at TP 1, 2 and 4: card == CPU at each
    degree and the same tokens at every degree."""
    import dataclasses
    for arch in ("smollm-360m", "mistral-7b"):
        cfg = dataclasses.replace(configs.reduced(configs.ARCHS[arch]),
                                  n_layers=2, dtype="float32")
        outs = {tp: engine_card_vs_cpu(torch, bridge, cfg, None, Engine,
                                       EngineConfig, Request, chips=tp)
                for tp in TP_DEGREES}
        check(all(o == outs[1] for o in outs.values()),
              f"{arch}: TP degrees disagree: {outs}")
        print(f"tp: reduced float32 {arch} token-identical at TP "
              f"{', '.join(map(str, TP_DEGREES))} (and card == CPU)")


# ---------------------------------------------------------------------------
# tensor-parallel instances, their submeshes emulated on the one card
# ---------------------------------------------------------------------------

TP_DEGREES = (1, 2, 4)
# the first dispatch's logits at TP 2 and 4 against TP 1's (max |diff|
# over the rms of TP 1's logits), on a copy of mistral-7b cut to its first
# TP_LOGIT_LAYERS layers (full width, the same weights) in float32: the
# shards sum their partial products in another order, so the logits
# differ by float32 rounding (~1e-5 of their rms on the CPU at reduced
# width); a wrong head or vocab shard moves them by about their rms. In
# bf16 the same difference reads 0.05-0.2 of the rms already at 2 layers
# (the random weights' near one-hot softmax turns rounding into flipped
# attention), and at all 32 layers O(rms) whatever the reduction order
# (PERF.md §6: the two data planes share no token there even in
# float32): both bf16 readings are printed, not gated.
TP_LOGIT_TOL = 1e-3
TP_LOGIT_LAYERS = 2


def tp_devices(tp):
    """The submesh of a TP degree on the one card (None: one chip)."""
    return ["cuda:0"] * tp if tp > 1 else None


@contextlib.contextmanager
def tap_first_logits(torch, store):
    """While open, the greedy head's first call records its float32
    logits over the whole vocab (a TP head's vocab shards joined in
    order) into ``store`` and passes through; later calls only pass."""
    from repro_torch.models import layers as L
    from repro_torch.models import zoo as Z
    one, tp = Z.top1_logits, L.top1_logits_tp

    def one_tap(h, w):
        if not store:
            store.append((h @ w).float())
        return one(h, w)

    def tp_tap(hs, ps, cfg, plan):
        if not store:
            parts = [(h @ L.head_matrix(p, cfg)).float().to(hs[0].device)
                     for h, p in zip(hs, ps)]
            store.append(torch.cat(parts, -1) if plan.vocab else parts[0])
        return tp(hs, ps, cfg, plan)
    Z.top1_logits, L.top1_logits_tp = one_tap, tp_tap
    try:
        yield
    finally:
        Z.top1_logits, L.top1_logits_tp = one, tp


def shard_bytes(torch, eng):
    """(weight bytes, pool bytes) of each shard, from its own tensors."""
    from repro_torch.launch.sharding import tree_bytes
    if eng.mesh is None:
        return [tree_bytes(eng.params)], [tree_bytes(eng.pages)]
    return ([tree_bytes(p) for p in eng.params],
            [tree_bytes(p) for p in eng.pages])


def mistral_tp_phase(torch, DA, PA, cfg, params, Engine, EngineConfig,
                     Request, gen_workload, flush):
    """mistral-7b at full width (the mistral phase's random weights) on
    the paged fused plane at TP 1, 2 and 4, the shards of a submesh all
    on the one card (head-wise: KH 8 gives 4 or 2 kv heads a shard), at
    the same device capacity, so every TP degree schedules alike. Checks
    one dispatch per step, paged-kernel launches = 32 x shards x
    dispatches, each shard's pool bytes 1/tp of TP 1's and weight bytes
    1/tp up to the replicated norms, every kernel input the shards gave
    (first layer of each dispatch) within the bf16 bound of its plain
    version (TP 1, one card, replays its pure-decode steps: they are
    held as the mistral phase holds its own, ``hold_replays``), and the
    first dispatch's float32 logits of the model cut to
    TP_LOGIT_LAYERS layers within TP_LOGIT_TOL of TP 1's (bf16 at that
    depth and at full depth printed only, with the share of tokens that
    agree); prints the plans, launches, bytes, walls and shard timers."""
    out, logits, outputs = {}, {}, {}
    for tp in TP_DEGREES:
        ec = dict(MISTRAL_ECONF, chips_per_instance=tp,
                  capacity_tokens=MISTRAL_ECONF["capacity_tokens"] // tp)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng = Engine(cfg, params, EngineConfig(**ec), device="cuda",
                     devices=tp_devices(tp))
        torch.cuda.synchronize()
        shard_s = time.perf_counter() - t0
        reqs = mistral_requests(Request, gen_workload, cfg.vocab_size)
        first, served, replays = [], {"decode": [], "paged": []}, []
        PA.paged_decode_attention.launches = 0
        PA.paged_decode_partials.launches = PA.lse_merge_partials.launches = 0
        with tap_first_logits(torch, first), \
                tap_decode_kernels(torch, cfg.n_layers * tp, served), \
                tap_graph_replays(replays):
            t0 = time.perf_counter()
            steps = serve_waves(eng, reqs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = PA.paged_decode_attention.launches
        name = f"mistral tp{tp}"
        check_outputs(name, reqs, cfg.vocab_size)
        st = eng.stats
        check(st["model_dispatches"] == st["iterations"],
              f"{name}: {st['model_dispatches']} dispatches in "
              f"{st['iterations']} iterations")
        check(launches == cfg.n_layers * tp * st["model_dispatches"],
              f"{name}: paged kernel launches {launches} != {cfg.n_layers} "
              f"x {tp} x {st['model_dispatches']} dispatches")
        check(PA.paged_decode_partials.launches == 0
              and PA.lse_merge_partials.launches == 0,
              f"{name}: a head-wise pool ran the slot path")
        plan = eng.plan
        if tp > 1:
            check(plan.pool == "head" and plan.heads and plan.kv_heads
                  and plan.ff and plan.vocab,
                  f"{name}: plan {plan.pool} heads {plan.heads} kv "
                  f"{plan.kv_heads} ff {plan.ff} vocab {plan.vocab}")
            check(all(p["p0"]["g0"]["k"].shape[2] == cfg.n_kv_heads // tp
                      for p in eng.pages), f"{name}: pool not head-wise")
        w, pool = shard_bytes(torch, eng)
        logits[tp] = first[0]
        outputs[tp] = [list(r.output_tokens) for r in reqs]
        out[tp] = dict(
            plan=(dict(pool=plan.pool, heads=plan.heads,
                       kv_heads=plan.kv_heads, ff=plan.ff, vocab=plan.vocab,
                       kv_heads_per_shard=cfg.n_kv_heads // tp)
                  if plan is not None else "one chip"),
            steps=steps, model_dispatches=st["model_dispatches"],
            paged_launches=launches, wall_s=wall, steps_per_s=steps / wall,
            shard_params_s=shard_s, weight_bytes_per_shard=w,
            pool_bytes_per_shard=pool,
            shard_dma_seconds=st["shard_dma_seconds"],
            collective_seconds=st["collective_seconds"],
            collective_share=st["collective_seconds"] / wall,
            reused_tokens=st["reused_tokens"],
            peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        check(not served["decode"], f"{name}: the split-K kernel ran")
        # TP 1 is one card: its pure-decode steps replay graphs
        check(len(replays) == st["decode_graph_replays"]
              and (len(replays) > 0) == (plan is None),
              f"{name}: {len(replays)} replays tapped, "
              f"{st['decode_graph_replays']} counted")
        if replays:
            out[tp]["decode_graphs"] = hold_replays(torch, PA, eng, replays,
                                                    served, name)
            replays.clear()
        rows = served_shapes(torch, DA, PA, flush,
                             {"paged": served["paged"]}, f"mistral-7b tp{tp}")
        out[tp]["served"] = rows.get("paged", [])
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    cut = {dt: cut_logits(torch, cfg, params, Engine, EngineConfig,
                          Request, gen_workload, dt)
           for dt in ("float32", "bfloat16")}
    for tp in TP_DEGREES[1:]:
        same = sum(a == b for x, y in zip(outputs[tp], outputs[1])
                   for a, b in zip(x, y))
        out[tp].update(logit_diff(logits[tp], logits[1], "full_depth"))
        for dt, c in cut.items():
            out[tp].update(logit_diff(c[tp], c[1],
                                      f"{TP_LOGIT_LAYERS}_layers_{dt}"))
        out[tp]["token_agreement_with_tp1"] = same / sum(
            map(len, outputs[1]))
    card = card_line()
    for tp in TP_DEGREES:
        o = {k: v for k, v in out[tp].items() if k != "served"}
        print(f"tp: mistral-7b tp{tp} " + json.dumps(dict(o, card=card)))
    w1, p1 = out[1]["weight_bytes_per_shard"][0], \
        out[1]["pool_bytes_per_shard"][0]
    for tp in TP_DEGREES[1:]:
        o = out[tp]
        check(all(p * tp == p1 for p in o["pool_bytes_per_shard"]),
              f"tp{tp}: pool bytes a shard {o['pool_bytes_per_shard']} are "
              f"not 1/{tp} of {p1}")
        check(all(abs(b * tp - w1) <= 1e-3 * w1
                  for b in o["weight_bytes_per_shard"]),
              f"tp{tp}: weight bytes a shard {o['weight_bytes_per_shard']} "
              f"are not 1/{tp} of {w1}")
        err = o[f"first_logits_err_over_rms_{TP_LOGIT_LAYERS}_layers_"
                "float32"]
        check(err <= TP_LOGIT_TOL, f"tp{tp}: the first dispatch's float32 "
              f"logits at {TP_LOGIT_LAYERS} layers are {err:.3g} x the rms "
              f"of TP 1's (tolerance {TP_LOGIT_TOL})")
    return out


def logit_diff(got, ref, tag):
    """max |got - ref| over the rms of ref, and the share of rows whose
    argmax agrees."""
    check(got.shape == ref.shape, f"first logits {tuple(got.shape)} vs "
          f"{tuple(ref.shape)}")
    return {f"first_logits_err_over_rms_{tag}": (
        (got - ref).abs().max() / ref.pow(2).mean().sqrt()).item(),
        f"first_argmax_agree_{tag}": (
            got.argmax(-1) == ref.argmax(-1)).float().mean().item()}


def cut_logits(torch, cfg, params, Engine, EngineConfig, Request,
               gen_workload, dtype):
    """The first dispatch's logits (the first 2 requests' first chunks)
    of mistral-7b cut to its first TP_LOGIT_LAYERS layers (full width, the
    same weights in ``dtype``) at each TP degree."""
    import dataclasses
    cut = dataclasses.replace(cfg, n_layers=TP_LOGIT_LAYERS, dtype=dtype)
    dt = getattr(torch, dtype)

    def head(tree, layers):
        if isinstance(tree, dict):
            return {k: head(v, layers) for k, v in tree.items()}
        return (tree[:TP_LOGIT_LAYERS] if layers else tree).to(dt)
    p = {"embed": head(params["embed"], False),
         "stack": head(params["stack"], True)}
    logits = {}
    for tp in TP_DEGREES:
        ec = dict(MISTRAL_ECONF, chips_per_instance=tp,
                  capacity_tokens=MISTRAL_ECONF["capacity_tokens"] // tp)
        eng = Engine(cut, p, EngineConfig(**ec), device="cuda",
                     devices=tp_devices(tp))
        first = []
        with tap_first_logits(torch, first):
            for r in mistral_requests(Request, gen_workload,
                                      cfg.vocab_size)[:2]:
                eng.scheduler.enqueue(r, 0.0)
            eng.step(0.0)
        logits[tp] = first[0]
        del eng
        gc.collect()
    return logits


@contextlib.contextmanager
def tap_slot_kernels(torch, n_layers, tp, served):
    """While open, the slot shards' partials launches and their merge
    pass straight through to their wrappers, and the first layer of each
    dispatch keeps, per shard, (q shape, slot pool shape, page table,
    the shard's lens) in ``served``."""
    from repro_torch.models import attention as A
    part, merge = A.paged_decode_partials, A.lse_merge_partials
    calls = {"partials": 0, "merge": 0}

    def part_tap(q, k, v, pt, lens):
        if calls["partials"] % (n_layers * tp) == 0:
            served.append([])
        if calls["partials"] % (n_layers * tp) < tp:
            served[-1].append((tuple(q.shape), tuple(k.shape), pt.clone(),
                               lens.clone()))
        calls["partials"] += 1
        return part(q, k, v, pt, lens)

    def merge_tap(*a, **kw):
        calls["merge"] += 1
        return merge(*a, **kw)
    A.paged_decode_partials, A.lse_merge_partials = part_tap, merge_tap
    try:
        yield
    finally:
        A.paged_decode_partials, A.lse_merge_partials = part, merge
    check(calls["partials"] == n_layers * tp * len(served)
          and calls["merge"] == n_layers * len(served),
          f"slot taps: {calls} for {len(served)} dispatches")


def slot_shapes(torch, PA, flush, served, tp):
    """Hold the partials entry and the merge against their plain versions
    on every input the slot shards gave them (random bf16 q and slot
    pools at the served shapes, the served page tables and shard lens):
    each shard's partials against the plain partials on the kernel's own
    splits, the merge of all shards' partials against the torch
    lse_merge, and that against unsharded plain paged attention over the
    shards' slots joined into whole pages. Then times the last input of
    each lane count: shard 0's partials launch (its bound: its valid KV,
    q, the f32 partials written; yardstick: SDPA over the same keys) and
    the merge (bound: the partials read, the output written)."""
    from repro_torch.analysis import counting
    g = torch.Generator(device="cuda").manual_seed(17)
    bf = torch.bfloat16
    sdpa = torch.nn.functional.scaled_dot_product_attention
    last, empty = {}, 0
    for shards in served:
        qs = shards[0][0]
        q = rand(torch, g, bf, *qs)
        pools = [(rand(torch, g, bf, *sh[1]), rand(torch, g, bf, *sh[1]))
                 for sh in shards]
        parts = []
        for (_, _, pt, ls), (k, v) in zip(shards, pools):
            empty += int((ls == 0).sum())
            got = PA.paged_decode_partials(q, k, v, pt, ls)
            ns, pps = PA.plan_for(q, k, pt)
            exp = PA.paged_decode_partials_plain(q, k, v, pt, ls, ns, pps)
            for name, a, b in zip(("m", "l", "acc"), got, exp):
                check(bool(((a == b) | (a - b).abs().le(
                    1e-3 + 1e-4 * b.abs())).all()),
                      f"slot partials {name} B{qs[0]} lens "
                      f"{ls.tolist()}: max |kernel - plain| "
                      f"{(a - b).abs().nan_to_num().max().item():.3e}")
            parts.append(got)
        acc, m, l = (torch.cat([p[i] for p in parts], 2) for i in range(3))
        o = PA.lse_merge_partials(acc, m, l, bf)
        close(torch, f"merge served B{qs[0]}", o,
              PA.lse_merge_partials_plain(acc, m, l, bf), BF16)
        k = torch.cat([p[0] for p in pools], 1)
        v = torch.cat([p[1] for p in pools], 1)
        lens = sum(sh[3] for sh in shards)
        close(torch, f"slotwise served B{qs[0]}", o,
              PA.paged_decode_attention_plain(q, k, v, shards[0][2], lens),
              BF16)
        n = last.get(qs[0], (0,))[0]
        last[qs[0]] = (n + 1, q, pools[0], shards[0], (acc, m, l))
    counts = {b: c[0] for b, c in sorted(last.items())}
    print(f"tp: smollm-360m tp{tp} slot partials and merge held against "
          f"their plain versions on all {len(served)} served dispatches "
          f"({empty} empty shard lanes; dispatches by lane count {counts})")
    rows = []
    for B, (n, q, (k, v), (_, _, pt, ls), (acc, m, l)) in sorted(
            last.items()):
        _, H, D = q.shape
        PSs, KH = k.shape[1], k.shape[2]
        P = pt.shape[1]
        ntok = int(ls.sum())
        ns, pps = PA.plan_for(q, k, pt)
        idx = pt.long()
        kg = k[idx].reshape(B, P * PSs, KH, D).permute(0, 2, 1, 3)
        vg = v[idx].reshape(B, P * PSs, KH, D).permute(0, 2, 1, 3)
        mask = (torch.arange(P * PSs, device="cuda")[None, :]
                < ls[:, None])[:, None, None, :]
        kg, vg = kg.contiguous(), vg.contiguous()
        part_out = B * KH * ns * (H // KH) * (D + 2) * 4
        b_ms, b_by = counting.bound_ms(
            ntok * KH * D * 2 * 2 + q.numel() * 2 + B * 4 + part_out,
            4 * ntok * H * D)
        prow = dict(kernel="paged_decode_partials", B=B, H=H, KH=KH, D=D,
                    slot_page=PSs, P=P, lens=ls.tolist(), n_splits=ns,
                    dispatches=n,
                    ms=time_ms(torch, lambda: PA.paged_decode_partials(
                        q, k, v, pt, ls), flush),
                    plain_ms=time_ms(torch, lambda: PA.
                                     paged_decode_partials_plain(
                                         q, k, v, pt, ls, ns, pps),
                                     flush, n=10),
                    library_ms=time_ms(torch, lambda: sdpa(
                        q[:, :, None], kg, vg, attn_mask=mask,
                        enable_gqa=True), flush),
                    bound_ms=b_ms, bound_by=b_by)
        prow["max_abs_err"] = max(
            (a - b).abs().nan_to_num().max().item() for a, b in zip(
                PA.paged_decode_partials(q, k, v, pt, ls),
                PA.paged_decode_partials_plain(q, k, v, pt, ls, ns, pps)))
        mb_ms, mb_by = counting.bound_ms(
            acc.numel() * 4 + 2 * m.numel() * 4 + B * H * D * 2, 0)
        mrow = dict(kernel="lse_merge_partials", B=B, H=H, D=D,
                    slots=acc.shape[2], dispatches=n,
                    max_abs_err=(PA.lse_merge_partials(acc, m, l, bf).float()
                                 - PA.lse_merge_partials_plain(
                                     acc, m, l, bf).float()).abs().max()
                    .item(),
                    ms=time_ms(torch, lambda: PA.lse_merge_partials(
                        acc, m, l, bf), flush),
                    plain_ms=time_ms(torch, lambda: PA.
                                     lse_merge_partials_plain(acc, m, l, bf),
                                     flush, n=10),
                    library_ms=None, bound_ms=mb_ms, bound_by=mb_by)
        for r in (prow, mrow):
            print("tp: slot served " + json.dumps(r))
        rows.append((B, n, prow, mrow))
    return rows


def smollm_slot_phase(torch, PA, configs, zoo, Engine, EngineConfig,
                      Request, gen_workload, flush, tp=2):
    """Full-width smollm-360m (bf16, random weights from seed 0) on a
    TP-2 engine on the one card: KH 5 gives a slot-wise pool (8 of a
    page's 16 slots a shard) and H 15 replicated heads. Serves the
    mistral phase's 8 distinct prompts (the first 2, then the rest);
    checks that every decode ran as tp partials launches and one merge
    per layer and dispatch, never the whole-page kernel, then holds both
    against their plain versions on the served inputs
    (``slot_shapes``)."""
    cfg = configs.get_config("smollm-360m")
    params = zoo.build(cfg).init(
        torch.Generator(device="cuda").manual_seed(0), "cuda")
    eng = Engine(cfg, params, EngineConfig(
        max_context=1024, chunk_size=64, max_batch_tokens=256, page_size=16,
        capacity_tokens=8192 // tp, chips_per_instance=tp),
        device="cuda", devices=tp_devices(tp))
    del params
    plan = eng.plan
    check(plan.pool == "slot" and not plan.heads and not plan.kv_heads
          and plan.slot_size == 16 // tp,
          f"smollm tp{tp}: plan {plan}")
    reqs = mistral_requests(Request, gen_workload, cfg.vocab_size)
    served = []
    PA.paged_decode_attention.launches = 0
    PA.paged_decode_partials.launches = PA.lse_merge_partials.launches = 0
    with tap_slot_kernels(torch, cfg.n_layers, tp, served):
        t0 = time.perf_counter()
        steps = serve_waves(eng, reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    st = eng.stats
    check_outputs(f"smollm tp{tp}", reqs, cfg.vocab_size)
    n = st["model_dispatches"]
    got = (PA.paged_decode_attention.launches,
           PA.paged_decode_partials.launches, PA.lse_merge_partials.launches)
    check(n == st["iterations"] and got == (0, cfg.n_layers * tp * n,
                                            cfg.n_layers * n),
          f"smollm tp{tp}: launches (paged, partials, merge) {got} for {n} "
          "dispatches")
    out = dict(steps=steps, model_dispatches=n, wall_s=wall,
               partials_launches=got[1], merge_launches=got[2],
               reused_tokens=st["reused_tokens"],
               shard_dma_seconds=st["shard_dma_seconds"],
               collective_seconds=st["collective_seconds"],
               weight_bytes_per_shard=shard_bytes(torch, eng)[0],
               pool_bytes_per_shard=shard_bytes(torch, eng)[1])
    print(f"tp: smollm-360m tp{tp} " + json.dumps(dict(out,
                                                       card=card_line())))
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    out["served"] = slot_shapes(torch, PA, flush, served, tp)
    return out


def rebalance_and_drain(cl, Request, vocab):
    """tests/test_torch_spmd.py::_rebalance_and_drain: the reference's
    heterogeneous stream on a [2, 1] cluster with 48 tokens a chip, 8
    unique prompts that push the shared prefix into instance 0's host
    tier, 3 re-hits routed to instance 1 (instance 0 flagged heavy) with
    a migration of the demoted prefix, then a drain of instance 0 and
    one more re-hit. Returns (placements, outputs, (migrations, migrated
    tokens), drained tokens)."""
    import numpy as np
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
        fail("heterogeneous cluster did not converge")

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


def hetero_cluster_phase(torch, configs, bridge, ClusterRuntime,
                         EngineConfig, Request):
    """A [2, 1] cluster with host tiers (reduced float32 smollm-360m), the
    2-chip instance's submesh on the one card, against the same cluster
    on the CPU: E2 must execute a migration and the drain move tokens;
    placements, outputs and migrations identical on both."""
    import dataclasses
    from repro_torch.core.cost_model import cost_model_for
    from repro_torch.core.global_scheduler import GlobalSchedulerConfig
    cfg = dataclasses.replace(configs.reduced(configs.ARCHS["smollm-360m"]),
                              n_layers=2, dtype="float32")
    params = bridge.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    kw = dict(max_context=96, chunk_size=16, max_batch_tokens=96,
              max_batch_requests=8, capacity_tokens=48, page_size=16,
              host_capacity_tokens=8192)
    runs, stats = {}, {}
    for dev in ("cpu", "cuda"):
        cl = ClusterRuntime(
            cfg, params, num_instances=2, engine_cfg=EngineConfig(**kw),
            cost_model=cost_model_for("llama3-70b"),
            scheduler_cfg=GlobalSchedulerConfig(
                th_bal=1e9, capacity_tokens=48, host_capacity_tokens=8192),
            chips_per_instance=[2, 1], device=dev,
            devices=["cuda:0"] * 3 if dev == "cuda" else None)
        check(cl.engines[0].mesh.size == 2 and cl.engines[1].mesh is None,
              f"{dev}: not a [2, 1] cluster")
        runs[dev] = rebalance_and_drain(cl, Request, cfg.vocab_size)
        stats[dev] = dict(cl.stats)
    check(runs["cuda"] == runs["cpu"],
          f"heterogeneous cluster: card {runs['cuda']} vs CPU {runs['cpu']}")
    (migr, migr_tok), moved = runs["cuda"][2], runs["cuda"][3]
    check(migr >= 1 and migr_tok > 0, "E2 executed no migration")
    check(moved > 0, "the drain migrated nothing")
    print(f"tp: heterogeneous [2, 1] cluster with host tiers on the card "
          f"== on the CPU ({len(runs['cuda'][1])} requests, placements "
          f"{runs['cuda'][0]}): {migr} E2 migration(s) of {migr_tok} tokens "
          f"executed, drain moved {moved} tokens; {json.dumps(stats['cuda'])}")


# ---------------------------------------------------------------------------
# MoE models at full width
# ---------------------------------------------------------------------------

# full widths of the MoE configs (their configs/*.py), cut in depth to
# what one H100 holds beside the pool and activations: bf16 weights
# 56.72 GiB at 12 of mixtral-8x22b's 56 layers, 57.99 GiB at 6 of
# grok-1-314b's 64 (param_bytes)
MOE_DEPTH = {"mixtral-8x22b": 12, "grok-1-314b": 6}
MOE_WIDTHS = {
    "mixtral-8x22b": dict(d_model=6144, n_heads=48, n_kv_heads=8,
                          head_dim=128, d_ff=16384, n_experts=8,
                          experts_per_token=2, vocab_size=32768,
                          sliding_window=4096, dtype="bfloat16"),
    "grok-1-314b": dict(d_model=6144, n_heads=48, n_kv_heads=8,
                        head_dim=128, d_ff=32768, n_experts=8,
                        experts_per_token=2, vocab_size=131072,
                        dtype="bfloat16")}
# the planes each model is served on at full width
MOE_PLANES = {"mixtral-8x22b": (("auto", None), ("dense", False)),
              "grok-1-314b": (("auto", None),)}


def moe_serve(torch, DA, PA, L, cfg, params, paged, Engine, EngineConfig,
              Request, gen_workload, served, dev="cuda"):
    """The mistral phase's stream served once by one engine on ``paged``'s
    plane with every count at 0: every request finished with prefix
    reuse, and the plane's decode kernel (and only it) launched once per
    layer per dispatch (paged) or decode batch (dense). Returns (numbers,
    outputs); the numbers include the routed MoE's calls, expert products
    and host syncs (``layers.MOE_STATS``)."""
    eng = Engine(cfg, params, EngineConfig(**MISTRAL_ECONF, paged=paged),
                 device=dev)
    reqs = mistral_requests(Request, gen_workload, cfg.vocab_size)
    if dev == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    DA.decode_attention.launches = PA.paged_decode_attention.launches = 0
    for k in L.MOE_STATS:
        L.MOE_STATS[k] = 0
    with tap_decode_kernels(torch, cfg.n_layers, served):
        t0 = time.perf_counter()
        steps = serve_waves(eng, reqs)
        if dev == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    split_k = DA.decode_attention.launches
    paged_l = PA.paged_decode_attention.launches
    moe = dict(L.MOE_STATS)
    name = f"{cfg.name} {'paged' if eng.paged else 'dense'}"
    check_outputs(name, reqs, cfg.vocab_size)
    st = eng.stats
    check(st["reused_tokens"] > 0, f"{name}: no prefix reuse")
    check(eng.paged == (paged is None), f"{name}: wrong data plane")
    if eng.paged:
        check(split_k == 0 and paged_l > 0
              and paged_l == cfg.n_layers * st["model_dispatches"],
              f"{name}: paged launches {paged_l} (split-K {split_k}) != "
              f"{cfg.n_layers} x {st['model_dispatches']} dispatches")
    else:
        check(paged_l == 0 and split_k > 0
              and split_k == cfg.n_layers * st["decode_batches"],
              f"{name}: split-K launches {split_k} (paged {paged_l}) != "
              f"{cfg.n_layers} x {st['decode_batches']} decode batches")
    check(moe["calls"] > 0 and moe["host_syncs"] == moe["calls"],
          f"{name}: routed MoE calls {moe}")
    reused, prefilled = st["reused_tokens"], st["prefilled_tokens"]
    out = dict(
        paged=eng.paged, steps=steps,
        model_dispatches=st["model_dispatches"],
        decode_batches=st["decode_batches"], reused_tokens=reused,
        prefilled_tokens=prefilled, reuse_share=reused / (reused + prefilled),
        wall_s=wall, steps_per_s=steps / wall,
        paged_decode_launches=paged_l, split_k_decode_launches=split_k,
        moe_routed_calls=moe["calls"],
        moe_routed_calls_per_layer_per_step=moe["calls"] / (
            cfg.n_layers * steps),
        experts_hit_per_routed_call=moe["expert_products"] / moe["calls"],
        moe_host_syncs=moe["host_syncs"],
        moe_host_syncs_per_step=moe["host_syncs"] / steps)
    if dev == "cuda":
        out["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    outputs = [list(r.output_tokens) for r in reqs]
    del eng
    return out, outputs


def first_layers(tree, n):
    """A copy of the first n layers of every stacked leaf."""
    if isinstance(tree, dict):
        return {k: first_layers(v, n) for k, v in tree.items()}
    return tree[:n].clone()


def cast_tree(torch, tree, dtype):
    if isinstance(tree, dict):
        return {k: cast_tree(torch, v, dtype) for k, v in tree.items()}
    return tree.to(dtype)


def moe_tp_cut(torch, PA, cfg, cut, Engine, EngineConfig, Request,
               gen_workload, dev="cuda"):
    """mixtral-8x22b cut to TP_LOGIT_LAYERS layers (full width, the
    phase's weights ``cut``) at TP 1, 2 and 4, every shard on the one
    card, in float32 (gated) and bf16 (printed): the expert-parallel arm
    (8 / 4 / 2 experts a shard, head-wise pools), paged launches = layers
    x shards x dispatches, and the first dispatch's logits against TP
    1's."""
    import dataclasses
    out = {tp: {} for tp in TP_DEGREES[1:]}
    for dtype in ("float32", "bfloat16"):
        c = dataclasses.replace(cfg, n_layers=TP_LOGIT_LAYERS, dtype=dtype)
        p = cast_tree(torch, cut, getattr(torch, dtype))
        logits = {}
        for tp in TP_DEGREES:
            ec = dict(MISTRAL_ECONF, chips_per_instance=tp,
                      capacity_tokens=MISTRAL_ECONF["capacity_tokens"] // tp)
            eng = Engine(c, p, EngineConfig(**ec), device=dev,
                         devices=tp_devices(tp) if dev == "cuda" else None)
            if tp > 1:
                plan = eng.plan
                check(plan.experts and not plan.expert_ff
                      and plan.pool == "head"
                      and all(s["stack"]["p0"]["ffn"]["wg"].shape[1]
                              == c.n_experts // tp for s in eng.params),
                      f"mixtral tp{tp}: plan experts {plan.experts} "
                      f"expert_ff {plan.expert_ff} pool {plan.pool}")
            PA.paged_decode_attention.launches = 0
            first = []
            with tap_first_logits(torch, first):
                for r in mistral_requests(Request, gen_workload,
                                          cfg.vocab_size)[:2]:
                    eng.scheduler.enqueue(r, 0.0)
                eng.step(0.0)
            n = TP_LOGIT_LAYERS * tp * eng.stats["model_dispatches"]
            check(dev != "cuda" or PA.paged_decode_attention.launches == n,
                  f"mixtral tp{tp} {dtype}: paged launches "
                  f"{PA.paged_decode_attention.launches} != {n}")
            logits[tp] = first[0]
            del eng
            gc.collect()
        for tp in TP_DEGREES[1:]:
            out[tp].update(logit_diff(logits[tp], logits[1],
                                      f"{TP_LOGIT_LAYERS}_layers_{dtype}"))
        del p, logits
        gc.collect()
        if dev == "cuda":
            torch.cuda.empty_cache()
    for tp in TP_DEGREES[1:]:
        err = out[tp][f"first_logits_err_over_rms_{TP_LOGIT_LAYERS}_layers_"
                      "float32"]
        check(err <= TP_LOGIT_TOL, f"mixtral tp{tp}: the first dispatch's "
              f"float32 logits at {TP_LOGIT_LAYERS} layers are {err:.3g} x "
              f"the rms of TP 1's (tolerance {TP_LOGIT_TOL})")
        print(f"moe: mixtral-8x22b {TP_LOGIT_LAYERS}-layer cut tp{tp} "
              + json.dumps(out[tp]))
    return out


def moe_phase(torch, DA, PA, configs, zoo, Engine, EngineConfig, Request,
              gen_workload, flush, dev="cuda"):
    """mixtral-8x22b (12 layers) on the paged and the dense plane and
    grok-1-314b (6 layers) on the paged plane, at full width with random
    bf16 weights from seed 0 on the card, serving the mistral phase's
    stream; each served kernel input held against the plain version;
    then the 2-layer TP cut of mixtral. Each model's weights are freed
    before the next is drawn."""
    import dataclasses
    from repro_torch.models import layers as L
    from repro_torch.serving.kv_offload import tree_leaves
    out = {}
    for arch, depth in MOE_DEPTH.items():
        full = configs.get_config(arch)
        check(all(getattr(full, k) == v for k, v in MOE_WIDTHS[arch].items()),
              f"{arch} is not at full width")
        cfg = dataclasses.replace(full, n_layers=depth)
        t0 = time.perf_counter()
        params = zoo.build(cfg).init(
            torch.Generator(device=dev).manual_seed(0), dev)
        if dev == "cuda":
            torch.cuda.synchronize()
        res = dict(layers=f"{depth} of {full.n_layers}",
                   init_s=time.perf_counter() - t0,
                   param_gib=sum(t.numel() * t.element_size()
                                 for _, t in tree_leaves(params)) / 2 ** 30)
        check(abs(res["param_gib"] * 2 ** 30 - zoo.build(cfg).n_bytes) < 1,
              f"{arch}: weights {res['param_gib']} GiB are not n_bytes")
        served = {"decode": [], "paged": []}
        outputs = {}
        for plane, paged in MOE_PLANES[arch]:
            res[plane], outputs[plane] = moe_serve(
                torch, DA, PA, L, cfg, params, paged, Engine, EngineConfig,
                Request, gen_workload, served, dev)
        if len(outputs) == 2:
            res.update(agreement(outputs))     # reported, not gated
        res["card"] = card_line() if dev == "cuda" else "cpu"
        print(f"moe: {arch} " + json.dumps(res))
        if dev == "cuda":
            res["served"] = served_shapes(
                torch, DA, PA, flush, {k: v for k, v in served.items() if v},
                arch)
        if arch == "mixtral-8x22b":
            cut = {"embed": params["embed"],
                   "stack": first_layers(params["stack"], TP_LOGIT_LAYERS)}
        del params
        gc.collect()
        if dev == "cuda":
            torch.cuda.empty_cache()
        if arch == "mixtral-8x22b":
            t0 = time.perf_counter()
            res["tp"] = moe_tp_cut(torch, PA, cfg, cut, Engine, EngineConfig,
                                   Request, gen_workload, dev)
            del cut
            gc.collect()
            if dev == "cuda":
                torch.cuda.empty_cache()
            print(f"moe: mixtral-8x22b TP cut took "
                  f"{time.perf_counter() - t0:.1f}s")
        out[arch] = res
    return out


def moe_reference_phase(torch, configs, bridge, Engine, EngineConfig,
                        Request):
    """Reduced float32 grok-1-314b and mixtral-8x22b (E 4, top 2; H 2,
    KH 1) on the card against the CPU, token-identical: the dense plane,
    and the paged plane at TP 1, 2 and 4 (the same tokens at every
    degree); then the half-expert MoE at TP 4 and 8 (split factors 1 and
    2), its shards on the one card, against moe_full on the CPU."""
    import dataclasses
    from repro_torch.launch import mesh as M
    from repro_torch.models import layers as L
    from repro_torch.models import moe_a2a
    for arch in MOE_DEPTH:
        cfg = dataclasses.replace(configs.reduced(configs.ARCHS[arch]),
                                  n_layers=2, dtype="float32")
        engine_card_vs_cpu(torch, bridge, cfg, False, Engine, EngineConfig,
                           Request)
        outs = {tp: engine_card_vs_cpu(torch, bridge, cfg, None, Engine,
                                       EngineConfig, Request, chips=tp)
                for tp in TP_DEGREES}
        check(all(o == outs[1] for o in outs.values()),
              f"{arch}: TP degrees disagree: {outs}")
        print(f"moe: reduced float32 {arch} token-identical at TP "
              f"{', '.join(map(str, TP_DEGREES))} (and card == CPU)")
    cfg = dataclasses.replace(configs.reduced(configs.ARCHS["mixtral-8x22b"]),
                              dtype="float32")
    g = torch.Generator().manual_seed(4)
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {"router": torch.randn(d, E, generator=g) / d ** 0.5,
         "wg": torch.randn(E, d, f, generator=g) / d ** 0.5,
         "wu": torch.randn(E, d, f, generator=g) / d ** 0.5,
         "wd": torch.randn(E, f, d, generator=g) / f ** 0.5}
    x = torch.randn(4, 16, d, generator=g)
    ref = L.moe_full(p, cfg, x)
    for tp in (4, 8):
        mesh = M.make_mesh(1, tp, devices=["cuda:0"] * tp)
        hp = dict(zip(("wg", "wu", "wd"),
                      moe_a2a.reshape_standard_to_halfexpert(
                          p["wg"], p["wu"], p["wd"], tp)),
                  router=p["router"])
        got = moe_a2a.moe_halfexpert(
            {k: v.cuda() for k, v in hp.items()},
            dataclasses.replace(cfg, moe_impl="halfexpert", moe_tp=tp),
            x.cuda(), mesh)
        err = ((got.cpu() - ref).abs().max() / ref.abs().max()).item()
        check(got.device.type == "cuda" and err <= 1e-5,
              f"moe_halfexpert tp{tp}: {err:.3g} of max |moe_full|")
        print(f"moe: reduced moe_halfexpert at TP {tp} (split factor "
              f"{tp // E}) on the card == moe_full on the CPU within "
              f"{err:.3g} of its largest entry")


# ---------------------------------------------------------------------------
# recurrent, hybrid and cross-attention stacks on the dense plane
# ---------------------------------------------------------------------------

# served at full width; jamba cut to 16 of 32 layers (two whole groups of
# its 8-position pattern: 2 attention and 8 MoE positions) to fit the card
REC_DEPTH = {"rwkv6-7b": 32, "jamba-v0.1-52b": 16,
             "llama-3.2-vision-11b": 40}
REC_WIDTHS = {
    "rwkv6-7b": dict(d_model=4096, d_ff=14336, vocab_size=65536,
                     rwkv_head_dim=64, attention_free=True,
                     dtype="bfloat16"),
    "jamba-v0.1-52b": dict(d_model=4096, n_heads=32, n_kv_heads=8,
                           head_dim=128, d_ff=14336, vocab_size=65536,
                           n_experts=16, experts_per_token=2,
                           mamba_d_state=16, mamba_d_conv=4,
                           mamba_expand=2, dtype="bfloat16"),
    "llama-3.2-vision-11b": dict(d_model=4096, n_heads=32, n_kv_heads=8,
                                 head_dim=128, d_ff=14336,
                                 vocab_size=128256, n_vision_tokens=1600,
                                 dtype="bfloat16")}
REC_ECONF = dict(max_context=4096, chunk_size=64, max_batch_tokens=256,
                 page_size=16, capacity_tokens=65536)
WHISPER_WIDTH = dict(n_layers=4, n_encoder_layers=4, d_model=384,
                     n_heads=6, n_kv_heads=6, head_dim=64, d_ff=1536,
                     vocab_size=51865, max_target_len=448)
WHISPER_FRAMES = 1500     # Whisper's 30 s window after its stride-2 conv
MIXER_TOL = 1e-4          # float32 chunk form vs chained steps, of max |x|


def rec_configs(configs):
    """The served configs at full width (jamba cut in depth)."""
    import dataclasses
    out = {}
    for arch, depth in REC_DEPTH.items():
        full = configs.get_config(arch)
        check(all(getattr(full, k) == v for k, v in REC_WIDTHS[arch].items()),
              f"{arch} is not at full width")
        out[arch] = dataclasses.replace(full, n_layers=depth)
    return out


def agent_requests(Request, gen_workload, vocab):
    """8 embodied-agent requests (seed 0: step k's prompt extends step
    k-1's with the action and the observation), with the first prompt
    repeated right after it. The repeat comes before the stream's second
    task splits the first prompt's radix node: after that split the dense
    plane's slab filed under the tail's key is stale (the reference's
    behaviour, ROADMAP queue 3), and a VLM repeat would reuse misaligned
    KV; the recurrent stacks' snapshots are keyed by tokens and do not
    care."""
    reqs = [Request(tokens=tuple(t % vocab for t in r.tokens),
                    max_new_tokens=r.max_new_tokens, workload=r.workload)
            for r in gen_workload("agent", 8, seed=0)]
    reqs.insert(1, Request(tokens=reqs[0].tokens,
                           max_new_tokens=reqs[0].max_new_tokens,
                           workload="agent"))
    return reqs


def split_k_calls(cfg):
    """Split-K decode calls a decode batch: one per attention position
    and one per cross-attention sub-block, in every group."""
    from repro_torch.models.transformer import layer_plan
    return cfg.n_groups * sum((p.mixer == "attn") + p.cross
                              for p in layer_plan(cfg))


def serve_one_by_one(eng, reqs, now=0.0, walls=None, max_iters=40000):
    """Enqueue each request after the previous one finished (so its
    snapshot or slabs exist); returns (engine steps, reused tokens of
    each request, the engine clock). ``walls``: a dict that gathers the
    host wall of the steps that ran a decode batch ("decode") and of the
    others ("prefill"; a step returns after the host read its tokens)."""
    steps, reuse = 0, []
    for r in reqs:
        before = eng.stats["reused_tokens"]
        eng.scheduler.enqueue(r, now)
        done = []
        while not done and steps < max_iters:
            batches = eng.stats["decode_batches"]
            t0 = time.perf_counter()
            done = eng.step(now)
            if walls is not None:
                kind = ("decode" if eng.stats["decode_batches"] > batches
                        else "prefill")
                walls[kind] = walls.get(kind, 0.0) + time.perf_counter() - t0
            now += 0.01
            steps += 1
        check(done == [r], f"request {r.request_id} did not finish alone")
        reuse.append(eng.stats["reused_tokens"] - before)
    return steps, reuse, now


def repeat_oracle(torch, eng, r, dev):
    """The outputs a fully matched prompt must get on an attention-only
    dense plane: the one stored slab's first prompt_len - 1 positions
    (the first request's KV) copied into a fresh cache, the last prompt
    token extended alone, then greedy decode steps — zoo entry points
    only, the same function the engine computes for the repeat."""
    check(len(eng.kv_store) == 1, f"{len(eng.kv_store)} slabs stored")
    slab = next(iter(eng.kv_store.values()))
    L = len(r.tokens) - 1
    cache = {pj: {n: torch.zeros(s.shape, dtype=s.dtype, device=dev)
                  for n, s in c.items()}
             for pj, c in eng.api.cache_specs(
                 1, eng.econf.max_context).items()}
    for pj, c in slab.items():
        for n in ("k", "v"):
            cache[pj][n][:, :, :L].copy_(c[n][:, :, :L])
    nxt, cache = eng.api.extend(
        eng.params, cache, {"tokens": torch.tensor([r.tokens[L:]],
                                                   device=dev), "start": L})
    outs = [int(nxt[0])]
    for t in range(r.max_new_tokens - 1):
        nxt, cache = eng.api.decode(eng.params, cache,
                                    {"tokens": nxt, "pos": L + 1 + t})
        outs.append(int(nxt[0]))
    return outs


def rec_serve(torch, DA, cfg, params, Engine, EngineConfig, Request,
              gen_workload, served, dev="cuda"):
    """One dense engine over the agent stream with the split-K count at
    0: every request finished; reuse > 0; each extension of the previous
    prompt reuses at least its prompt_len - 1 tokens, the repeat exactly
    prompt_len - 1; split-K launches = calls a decode batch x decode
    batches. A recurrent stack's repeat must give the first request's
    outputs: both end their prefill with the same one-token chunk from
    the same state (the snapshot boundary). An attention-only stack's
    first request prefills its last token inside a chunk and the repeat
    alone, and bf16 products of another row count round otherwise
    (random-init logits amplify it), so its repeat is held to
    ``repeat_oracle`` exactly and its agreement with the first request
    is reported."""
    eng = Engine(cfg, params, EngineConfig(**REC_ECONF), device=dev)
    check(not eng.paged, f"{cfg.name}: not on the dense plane")
    reqs = agent_requests(Request, gen_workload, cfg.vocab_size)
    per = split_k_calls(cfg)
    if dev == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    DA.decode_attention.launches = 0
    steps, reuse, now, wall, walls = 0, [], 0.0, 0.0, {}
    for part in (reqs[:2], reqs[2:]):
        with tap_decode_kernels(torch, per, served):
            t0 = time.perf_counter()
            n, part_reuse, now = serve_one_by_one(eng, part, now, walls)
            if dev == "cuda":
                torch.cuda.synchronize()
            wall += time.perf_counter() - t0
        steps += n
        reuse += part_reuse
        if len(reuse) == 2 and not eng.has_recurrent:
            # before the next task splits the first prompt's node
            launches = DA.decode_attention.launches
            oracle = repeat_oracle(torch, eng, reqs[1], dev)
            DA.decode_attention.launches = launches
    launches = DA.decode_attention.launches
    name = f"{cfg.name} dense"
    check_outputs(name, reqs, cfg.vocab_size)
    st = eng.stats
    check(st["reused_tokens"] > 0, f"{name}: no prefix reuse")
    extensions = 0
    for prev, r, n in zip(reqs[1:], reqs[2:], reuse[2:]):
        if r.tokens[:len(prev.tokens)] == prev.tokens:
            extensions += 1
            check(n >= len(prev.tokens) - 1,
                  f"{name}: request {r.request_id} reused {n} < "
                  f"{len(prev.tokens) - 1} of the step it extends")
    check(extensions > 0, f"{name}: the stream holds no extension")
    check(reuse[1] == len(reqs[1].tokens) - 1,
          f"{name}: the repeat reused {reuse[1]} of {len(reqs[1].tokens)}")
    same = sum(a == b for a, b in zip(reqs[0].output_tokens,
                                      reqs[1].output_tokens))
    if eng.has_recurrent:
        check(reqs[1].output_tokens == reqs[0].output_tokens,
              f"{name}: the repeat {reqs[1].output_tokens} != the first "
              f"request {reqs[0].output_tokens}")
    else:
        check(reqs[1].output_tokens == oracle,
              f"{name}: the repeat {reqs[1].output_tokens} != its oracle "
              f"{oracle}")
    check(launches == per * st["decode_batches"] and st["decode_batches"],
          f"{name}: split-K launches {launches} != {per} x "
          f"{st['decode_batches']} decode batches")
    snaps = [t for snap in eng.state_store.values() for c in snap.values()
             for t in c.values()]
    reused, prefilled = st["reused_tokens"], st["prefilled_tokens"]
    out = dict(
        steps=steps, model_dispatches=st["model_dispatches"],
        decode_batches=st["decode_batches"], reused_tokens=reused,
        prefilled_tokens=prefilled, reuse_share=reused / (reused + prefilled),
        reuse_per_request=reuse, extensions=extensions,
        repeat_tokens_equal_to_first=f"{same} of {len(reqs[0].output_tokens)}",
        prompt_lens=[len(r.tokens) for r in reqs], wall_s=wall,
        steps_per_s=steps / wall, prefill_steps_s=walls.get("prefill", 0.0),
        decode_steps_s=walls.get("decode", 0.0),
        prefill_ms_per_token=1e3 * walls.get("prefill", 0.0) / prefilled,
        decode_ms_per_batch=1e3 * walls.get("decode", 0.0)
        / max(st["decode_batches"], 1), split_k_per_decode_batch=per,
        split_k_launches=launches,
        snapshot_entries=len(eng.state_store),
        snapshot_bytes=sum(t.numel() * t.element_size() for t in snaps),
        kv_store_entries=len(eng.kv_store))
    if dev == "cuda":
        out["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    del eng
    return out


def rec_profile(torch, cfg, params, Engine, EngineConfig, Request,
                gen_workload, n=4):
    """The first request of the agent stream alone on a new engine, with
    two windows under torch.profiler (device activity only): ``n``
    prefill-chunk steps (after 8 unprofiled chunks) and ``n`` decode
    steps (after one unprofiled decode). For each: the device busy share
    of the window's wall, launches a step, the device time of the
    split-K decode (split kernel and merge) and of the cache
    concatenations, and the costliest kernels. Instrumentation only: the
    phase's walls are the unprofiled run's; short windows keep the
    profiler's own processing (seconds per 10^5 events) small."""
    from torch.profiler import ProfilerActivity, profile
    eng = Engine(cfg, params, EngineConfig(**REC_ECONF), device="cuda")
    r = agent_requests(Request, gen_workload, cfg.vocab_size)[0]
    clock = [0.0]

    def step():
        eng.step(clock[0])
        clock[0] += 0.01

    eng.scheduler.enqueue(r, 0.0)
    for _ in range(8):
        step()
    out = {}
    for kind in ("prefill", "decode"):
        if kind == "decode":
            while not r.output_tokens:
                step()
            step()
        check(len(r.output_tokens) + n < r.max_new_tokens,
              f"{cfg.name}: too few decode steps to profile")
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kernels = device_kernels(torch, prof)
        busy_ms = sum(k[0] for k in kernels) / 1e3
        if busy_ms == 0.0:
            return "not measured (the profiler recorded no device time)"

        def ms(*names):
            return sum(k[0] for k in kernels
                       if any(x in k[2] for x in names)) / 1e3
        out[kind] = dict(
            steps=n, wall_ms=wall * 1e3, device_busy_ms=busy_ms,
            device_busy_share=busy_ms / (wall * 1e3),
            launches_per_step=sum(k[1] for k in kernels) / n,
            split_k_decode_ms=ms("dense_split_kernel", "lse_merge_kernel"),
            concat_ms=ms("CatArrayBatchedCopy"),
            top=[dict(kernel=k[2][:60], ms=k[0] / 1e3, calls=k[1])
                 for k in kernels[:5]])
    return out


def rec_phase(torch, DA, cfgs, zoo, Engine, EngineConfig, Request,
              gen_workload, flush, dev="cuda"):
    """rwkv6-7b, jamba-v0.1-52b (16 layers) and llama-3.2-vision-11b at
    full width, random bf16 weights from seed 0, one dense engine each
    over the agent stream (``rec_serve``); every split-K input held
    against the plain version and timed. Each model's weights are freed
    before the next is drawn."""
    from repro_torch.serving.kv_offload import tree_leaves
    out = {}
    for arch, cfg in cfgs.items():
        t0 = time.perf_counter()
        params = zoo.build(cfg).init(
            torch.Generator(device=dev).manual_seed(0), dev)
        if dev == "cuda":
            torch.cuda.synchronize()
        res = dict(layers=f"{cfg.n_layers}", init_s=time.perf_counter() - t0,
                   param_gib=sum(t.numel() * t.element_size()
                                 for _, t in tree_leaves(params)) / 2 ** 30)
        check(abs(res["param_gib"] * 2 ** 30 - zoo.build(cfg).n_bytes) < 1,
              f"{arch}: weights {res['param_gib']} GiB are not n_bytes")
        served = {"decode": [], "paged": []}
        res["dense"] = rec_serve(torch, DA, cfg, params, Engine,
                                 EngineConfig, Request, gen_workload, served,
                                 dev)
        res["card"] = card_line() if dev == "cuda" else "cpu"
        if dev == "cuda":
            res["profile"] = rec_profile(torch, cfg, params, Engine,
                                         EngineConfig, Request, gen_workload)
        print(f"recurrent: {arch} " + json.dumps(res))
        del params
        gc.collect()
        if dev == "cuda":
            torch.cuda.empty_cache()
        check(not served["paged"], f"{arch}: the paged kernel ran")
        if dev == "cuda" and served["decode"]:
            res["served"] = served_shapes(torch, DA, None, flush,
                                          {"decode": served["decode"]}, arch)
        out[arch] = res
    return out


def whisper_phase(torch, DA, configs, zoo, flush, dev="cuda", cfg=None,
                  frames_len=WHISPER_FRAMES):
    """whisper-tiny at full width in float32 (random weights, seed 0):
    encode 1500 frames and prefill 8 decoder tokens of 2 lanes, then 8
    decode steps; each step's tokens must equal a full prefill of the
    prompt so far (tests/test_consistency.py::test_whisper_incremental
    on the card). The decode runs the split-K kernel twice a layer (self
    over the 448-position cache, cross over the frames): launches = 8 x
    2 x layers, every input held against the plain version."""
    import dataclasses
    if cfg is None:
        full = configs.get_config("whisper-tiny")
        check(all(getattr(full, k) == v for k, v in WHISPER_WIDTH.items()),
              "whisper-tiny is not at full width")
        cfg = dataclasses.replace(full, dtype="float32")
    api = zoo.build(cfg)
    check(api.extend is None, "whisper-tiny has a chunk extension")
    params = api.init(torch.Generator(device=dev).manual_seed(0), dev)
    g = torch.Generator(device=dev).manual_seed(1)
    frames = 0.02 * torch.randn(2, frames_len, cfg.d_model, generator=g,
                                device=dev)
    toks = torch.randint(0, cfg.vocab_size, (2, 16), generator=g,
                         device=dev)
    t0 = time.perf_counter()
    nxt, cache = api.prefill(params, {"tokens": toks[:, :8],
                                      "frames": frames})
    check(tuple(cache["p0"]["k"].shape[2:3]) == (cfg.max_target_len,)
          and cache["p0"]["ck"].shape[2] == frames_len,
          f"whisper cache {tuple(cache['p0']['k'].shape)}")
    served, steps = {"decode": [], "paged": []}, []
    DA.decode_attention.launches = 0
    with tap_decode_kernels(torch, 2 * cfg.n_layers, served):
        for t in range(8, 16):
            nxt, cache = api.decode(params, cache,
                                    {"tokens": toks[:, t], "pos": t})
            full, _ = api.prefill(params, {"tokens": toks[:, :t + 1],
                                           "frames": frames})
            steps.append(nxt.tolist())
            check(nxt.tolist() == full.tolist(),
                  f"whisper step {t}: decode {nxt.tolist()} != prefill "
                  f"{full.tolist()}")
    launches = DA.decode_attention.launches
    check(launches == 8 * 2 * cfg.n_layers,
          f"whisper: split-K launches {launches} != 8 x 2 x "
          f"{cfg.n_layers}")
    if dev == "cuda":
        torch.cuda.synchronize()
    out = dict(frames=frames_len, steps=steps, split_k_launches=launches,
               wall_s=time.perf_counter() - t0)
    print("whisper: " + json.dumps(out) + " (every decode step == the "
          "full prefill's token)")
    check(not served["paged"], "whisper: the paged kernel ran")
    if dev == "cuda":
        out["served"] = served_shapes(torch, DA, None, flush,
                                      {"decode": served["decode"]},
                                      "whisper-tiny")
    return out


def one_layer(torch, bridge, cfg, sub, dev, seed):
    """Group 0's float32 leaves of the first layer position's ``sub``
    tree, drawn from the specs' init kinds."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def draw(s):
        shape = s.shape[1:]
        if s.init in ("zeros", "ones"):
            return torch.full(shape, float(s.init == "ones"), device=dev)
        scale = (1.0 / math.sqrt(shape[-2]) if s.init == "fan_in"
                 else s.scale)
        return scale * torch.randn(shape, generator=g, device=dev)
    return {k: draw(v)
            for k, v in bridge.param_specs(cfg)["stack"]["p0"][sub].items()}


def mixer_phase(torch, bridge, cfgs, dev="cuda", S=64):
    """One full-width layer of each mixer in float32 on the card (mamba
    at jamba width, RWKV-6 time- and channel-mix at rwkv6 width): the
    chunk form over S tokens equals S chained one-token steps, outputs
    and final state within MIXER_TOL of their largest |value| (the two
    sum in other orders)."""
    import dataclasses
    from repro_torch.models import mamba as M
    from repro_torch.models import rwkv6 as R
    out = {}

    def gate(name, got, want):
        err = (got - want).abs().max().item() / want.abs().max().item()
        check(math.isfinite(err) and err <= MIXER_TOL,
              f"{name}: chunk form vs steps {err:.3g} of max |x|")
        out[name] = err

    cfg = dataclasses.replace(cfgs["jamba-v0.1-52b"], dtype="float32")
    p = one_layer(torch, bridge, cfg, "mamba", dev, 0)
    x = torch.randn(1, S, cfg.d_model,
                    generator=torch.Generator(device=dev).manual_seed(1),
                    device=dev)
    y, c = M.mamba_full(p, cfg, x)
    ed = cfg.mamba_expand * cfg.d_model
    cs = {"conv": torch.zeros(1, cfg.mamba_d_conv - 1, ed, device=dev),
          "ssm": torch.zeros(1, ed, cfg.mamba_d_state, device=dev)}
    ys = torch.stack([M.mamba_step(p, cfg, x[:, t], cs)[0]
                      for t in range(S)], 1)
    gate("mamba y", ys, y)
    gate("mamba ssm", cs["ssm"], c["ssm"])
    gate("mamba conv", cs["conv"], c["conv"])
    del p
    cfg = dataclasses.replace(cfgs["rwkv6-7b"], dtype="float32")
    x = torch.randn(1, S, cfg.d_model,
                    generator=torch.Generator(device=dev).manual_seed(2),
                    device=dev)
    H, Dh = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    p = one_layer(torch, bridge, cfg, "time", dev, 3)
    y, c = R.rwkv_time_full(p, cfg, x)
    cs = {"state": torch.zeros(1, H, Dh, Dh, device=dev),
          "shift": torch.zeros(1, cfg.d_model, device=dev)}
    ys = torch.stack([R.rwkv_time_step(p, cfg, x[:, t], cs)[0]
                      for t in range(S)], 1)
    gate("rwkv time y", ys, y)
    gate("rwkv state", cs["state"], c["state"])
    p = one_layer(torch, bridge, cfg, "channel", dev, 4)
    y, _ = R.rwkv_channel_full(p, cfg, x)
    cs = {"shift_c": torch.zeros(1, cfg.d_model, device=dev)}
    ys = torch.stack([R.rwkv_channel_step(p, cfg, x[:, t], cs)[0]
                      for t in range(S)], 1)
    gate("rwkv channel y", ys, y)
    print(f"mixers: one full-width float32 layer, chunk form over {S} "
          f"tokens vs {S} chained steps (gate {MIXER_TOL} of max |x|): "
          + json.dumps(out))
    return out


def snapshot_card_vs_cpu(torch, bridge, cfg, Engine, EngineConfig, Request):
    """tests/test_engine_cluster.py's snapshot stream (24 shared tokens
    alone, then its repeat and an 8-token extension) on the dense engine,
    card against CPU: outputs and stats identical, the recurrent stacks
    reusing at least 2 x 23 tokens."""
    params = bridge.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    gen = torch.Generator().manual_seed(1)
    shared = tuple(torch.randint(1, cfg.vocab_size, (24,),
                                 generator=gen).tolist())
    ext = shared + tuple(torch.randint(1, cfg.vocab_size, (8,),
                                       generator=gen).tolist())
    outs = {}
    for dev in ("cpu", "cuda"):
        eng = Engine(cfg, params, EngineConfig(
            max_context=64, chunk_size=16, max_batch_tokens=64,
            capacity_tokens=4096, page_size=16), device=dev)
        reqs = [Request(tokens=shared, max_new_tokens=3),
                Request(tokens=shared, max_new_tokens=3),
                Request(tokens=ext, max_new_tokens=3)]
        now, done = 0.0, []
        eng.scheduler.enqueue(reqs[0], now)
        while len(done) < 1:
            done += eng.step(now)
            now += 0.01
        for r in reqs[1:]:
            eng.scheduler.enqueue(r, now)
        while len(done) < 3:
            done += eng.step(now)
            now += 0.01
        check(not eng.paged, f"{cfg.name}: not on the dense plane")
        check(reqs[0].output_tokens == reqs[1].output_tokens,
              f"{cfg.name} {dev}: the repeat differs")
        if eng.has_recurrent:
            check(eng.stats["reused_tokens"] >= 2 * (len(shared) - 1),
                  f"{cfg.name} {dev}: reused {eng.stats['reused_tokens']}")
        outs[dev] = ([list(r.output_tokens) for r in reqs],
                     dict(eng.stats))
    check(outs["cuda"] == outs["cpu"],
          f"{cfg.name}: card and CPU engines disagree: {outs['cuda']} vs "
          f"{outs['cpu']}")
    print(f"reference: reduced float32 {cfg.name} dense engine, snapshot "
          f"stream, on the card == on the CPU (outputs and stats; reused "
          f"{outs['cuda'][1]['reused_tokens']})")


def rec_reference_phase(torch, configs, bridge, Engine, EngineConfig,
                        Request):
    import dataclasses
    for arch in REC_DEPTH:
        cfg = dataclasses.replace(configs.reduced(configs.ARCHS[arch]),
                                  dtype="float32")
        snapshot_card_vs_cpu(torch, bridge, cfg, Engine, EngineConfig,
                             Request)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 1024, 12
TRAIN_WIDTH = dict(n_layers=32, d_model=960, n_heads=15, n_kv_heads=5,
                   vocab_size=49152, tie_embeddings=True, dtype="bfloat16")
TRAIN_SWITCHES = (dict(grad_accum=2), dict(compress_grads=True),
                  dict(quant_moments=True))
TRAIN_CLI = ["--log-every", "1"]          # the reference's defaults else
TRAIN_CHECK_ARCHS = ("smollm-360m", "mixtral-8x22b", "rwkv6-7b",
                     "jamba-v0.1-52b", "llama-3.2-vision-11b",
                     "whisper-tiny")
TRAIN_RTOL = 1e-4       # card vs CPU loss and grad norm, float32
TRAIN_FAN_IN_GAIN = 0.3
BF16_REL = 2 ** -7      # one bfloat16 ulp, relative
# device kernels of a profiled train step by kind (first match wins):
# float32 GEMMs are the naive attention's score and value products
TRAIN_KERNEL_KINDS = (
    ("f32 gemm", ("f32f32",)),
    ("gemm", ("gemm", "xmma", "cutlass", "sm90_", "nvjet")),
    ("softmax", ("softmax",)),
    ("reduce", ("reduce",)),
    ("copy / cat / index", ("copy", "Cat", "index", "gather", "scatter",
                            "embedding")),
    ("elementwise", ("elementwise",)))


def sync(torch, dev):
    if dev == "cuda":
        torch.cuda.synchronize()


def tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def flat_leaves(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(flat_leaves(tree[k], prefix + (k,)))
        return out
    return {prefix: tree}


def spread(xs):
    xs = sorted(xs)
    return dict(median=xs[len(xs) // 2], min=xs[0], max=xs[-1])


def profile_train_step(torch, step, state, batch):
    """One more step under torch.profiler (device activity only): kernel
    launches, device busy ms and busy share of the step's wall, the
    costliest kernels. Instrumentation only."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = step(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = device_kernels(torch, prof)
    busy_ms = sum(k[0] for k in kernels) / 1e3
    if busy_ms == 0.0:
        return "not measured (the profiler recorded no device time)"
    kinds = {}
    for us, calls, name in kernels:
        kind = next((kd for kd, keys in TRAIN_KERNEL_KINDS
                     if any(x in name for x in keys)), "other")
        ms, n = kinds.get(kind, (0.0, 0))
        kinds[kind] = (ms + us / 1e3, n + calls)
    return dict(wall_ms=wall * 1e3, launches=sum(k[1] for k in kernels),
                device_busy_ms=busy_ms,
                device_busy_share=busy_ms / (wall * 1e3),
                by_kind={k: dict(ms=ms, calls=n)
                         for k, (ms, n) in sorted(kinds.items(),
                                                  key=lambda x: -x[1][0])},
                top=[dict(kernel=k[2][:70], ms=k[0] / 1e3, calls=k[1])
                     for k in kernels[:8]])


def train_steps(torch, T, api, params, tc, batches, dev, label):
    """``len(batches)`` steps of ``make_train_step(api, tc)`` from fresh
    state over ``params``: per-step [loss, grad norm, lr] and walls (the
    host clock around each step, synchronized); every loss checked
    finite. Returns (rows, walls, final state, step fn)."""
    step = T.make_train_step(api, tc)
    state = T.init_state(params, tc)
    rows, walls = [], []
    for i, b in enumerate(batches):
        t0 = time.perf_counter()
        state, m = step(state, b)
        sync(torch, dev)
        walls.append(time.perf_counter() - t0)
        rows.append([float(m[k]) for k in ("loss", "grad_norm", "lr")])
        print(f"train: {label} step {i + 1:2d} loss={rows[-1][0]:.6f} "
              f"gnorm={rows[-1][1]:.6g} lr={rows[-1][2]:.3e} "
              f"wall={walls[-1] * 1e3:.1f} ms")
    losses = [r[0] for r in rows]
    check(all(math.isfinite(x) for x in losses),
          f"train {label}: a loss is not finite: {losses}")
    return rows, walls, state, step


def train_full_width(torch, T, tcli, bridge, api, dev, card,
                     batch=TRAIN_BATCH, seq=TRAIN_SEQ, steps=TRAIN_STEPS):
    """From random weights (``train_params``, seed 0): ``steps`` steps at
    ``TrainConfig()``
    defaults (remat on) on ``synthetic_batches(seed=0)``, each step's
    loss, grad norm and lr, the wall of steps 3.. (median, spread),
    tokens/s, the model-FLOP share (``model_flops_for``: 6 N T, over
    wall x 989e12), peak memory
    against the state's 16 bytes a parameter and one profiled step;
    then ``steps`` steps on the stream's first batch repeated, at the
    reference's single-batch overfit settings (lr 3e-3, warmup 5,
    tests/test_train_substrate.py): the last loss must be below the
    first (at the defaults' warmup the lr stays under 3.3e-5 for 12
    steps, too little to move a random 32-layer stack's loss). Returns
    the initial parameters and the fixed batch."""
    cfg = api.cfg
    params = train_params(torch, bridge, cfg, 0, dev)
    data = tcli.synthetic_batches(cfg.vocab_size, batch, seq, seed=0,
                                  device=dev)
    batches = [next(data) for _ in range(steps)]
    sync(torch, dev)
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    rows, walls, state, step = train_steps(
        torch, T, api, params, T.TrainConfig(), batches, dev, "stream")
    from repro_torch.analysis.roofline import PEAK_FLOPS, model_flops_for
    from repro_torch.configs import ShapeSpec
    n = api.n_active_params
    tokens = batch * seq
    wall = spread(walls[2:])
    model_flops = model_flops_for(cfg, ShapeSpec("train", seq, batch,
                                                 "train"), n)
    out = dict(arch=cfg.name, layers=cfg.n_layers, batch=batch, seq=seq,
               steps=steps, params=n, step_wall_s=wall,
               first_step_s=walls[0],
               tokens_per_s=tokens / wall["median"],
               model_flop_share=model_flops / (wall["median"] * PEAK_FLOPS),
               card=card)
    if dev == "cuda":
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        out["state_gib_16_bytes_a_param"] = 16 * n / 2 ** 30
        out["profile"] = profile_train_step(torch, step, state, batches[-1])
    print("train: full width " + json.dumps(out))
    del state
    fixed = T.TrainConfig(adamw=T.AdamWConfig(lr=3e-3), warmup_steps=5,
                          total_steps=200)
    rows, _, state, _ = train_steps(torch, T, api, params, fixed,
                                    [batches[0]] * steps, dev, "fixed")
    losses = [r[0] for r in rows]
    check(losses[-1] < losses[0],
          f"train: the fixed batch's loss did not fall: {losses}")
    out["fixed_batch_losses"] = losses
    del state
    return params, batches[0]


def train_switches(torch, T, api, params, b, dev):
    """One step each of grad_accum=2, compress_grads and quant_moments
    from the same weights and batch: a finite loss, and the optimizer
    state's moment bytes (float32 against int8 with a float32 scale a
    row)."""
    out = {}
    for opts in TRAIN_SWITCHES:
        tc = T.TrainConfig(**opts)
        state = T.init_state(params, tc)
        t0 = time.perf_counter()
        state, m = T.make_train_step(api, tc)(state, b)
        sync(torch, dev)
        name = ",".join(opts)
        loss = float(m["loss"])
        check(math.isfinite(loss), f"train {name}: loss {loss}")
        out[name] = dict(loss=loss, grad_norm=float(m["grad_norm"]),
                         wall_s=time.perf_counter() - t0,
                         moment_bytes=tree_bytes(state.opt["m"])
                         + tree_bytes(state.opt["v"]),
                         state_bytes=tree_bytes(state.as_dict()))
        del state
    print("train: switches " + json.dumps(out))
    return out


def train_cli(torch, T, tcli, ckpt, configs, zoo, dev, extra=()):
    """``launch.train.main`` in-process: 3 steps with a checkpoint, every
    restored leaf bit-equal to the returned state, one step from the
    restored state against one from the returned state (loss and grad
    norm within one bf16 ulp relative, parameters within one bf16 ulp
    plus 2.1 lr: the embedding's backward accumulates with atomics on
    the card, so the grads need not be bit-equal), then
    a second call to step 5 that resumes from step 3."""
    import tempfile
    (ROOT / "build").mkdir(exist_ok=True)
    args = TRAIN_CLI + ["--device", dev] + list(extra)
    out = {}
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        for steps in (3, 5):
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                state = tcli.main(args + ["--steps", str(steps),
                                          "--ckpt-dir", d])
            out[f"main_to_{steps}_s"] = time.perf_counter() - t0
            text = buf.getvalue()
            print("".join(f"train: cli: {line}\n"
                          for line in text.splitlines()), end="")
            check(int(state.step) == steps, f"train cli: step {state.step}")
            if steps == 5:
                check("resumed from step 3" in text,
                      "train cli: the second call did not resume")
                break
            t0 = time.perf_counter()
            restored = T.TrainState.from_dict(
                ckpt.restore_checkpoint(d, step=3, device=dev))
            out["restore_s"] = time.perf_counter() - t0
            a, r = (flat_leaves(s.as_dict()) for s in (state, restored))
            check(set(a) == set(r), "train cli: restored paths differ")
            for k in a:
                check(a[k].dtype == r[k].dtype and torch.equal(a[k], r[k]),
                      f"train cli: restored leaf {k} differs")
            out["restored_leaves"] = len(a)
            out["checkpoint_bytes"] = tree_bytes(state.as_dict())
            pa = tcli.parse_args(args + ["--steps", "3"])
            cfg = configs.get_config(pa.arch)
            if pa.reduced:
                cfg = configs.reduced(cfg)
            tc = T.TrainConfig(adamw=T.AdamWConfig(lr=pa.lr),
                               warmup_steps=max(pa.steps // 20, 1),
                               total_steps=pa.steps)
            step = T.make_train_step(zoo.build(cfg), tc)
            data = tcli.synthetic_batches(cfg.vocab_size, pa.batch, pa.seq,
                                          pa.seed, device=dev)
            for _ in range(4):
                b = next(data)
            sa, ma = step(state, b)
            sr, mr = step(restored, b)
            lr = float(ma["lr"])
            diff = {k: abs(float(ma[k]) - float(mr[k])) / float(ma[k])
                    for k in ("loss", "grad_norm")}
            check(all(v <= BF16_REL for v in diff.values()),
                  f"train cli: the resumed step's {diff} relative")
            use, differ = 0.0, 0
            pa_, pr_ = flat_leaves(sa.params), flat_leaves(sr.params)
            for k in pa_:
                x, y = pa_[k].float(), pr_[k].float()
                bound = BF16_REL * x.abs() + 2.1 * lr
                use = max(use, ((x - y).abs() / bound).max().item())
                differ += int((x != y).sum())
            check(use <= 1.0, f"train cli: resumed step {use:.3g} x the "
                  "bf16 bound")
            out["resumed_step"] = dict(rel=diff, params_differ=differ,
                                       share_of_bound=use)
            del state, restored, sa, sr
    print("train: cli " + json.dumps(out))
    return out


def train_params(torch, bridge, cfg, seed, dev="cpu",
                 gain=TRAIN_FAN_IN_GAIN):
    """Random parameters on ``dev`` from a ``torch.Generator`` (seed),
    each leaf in its dtype, in the specs' shapes and init kinds with the
    "fan_in" leaves at ``gain`` of the reference's 1 / sqrt(shape[-2]).
    At the full scale the stacks are too ill-conditioned to train or to
    compare: a reduced stack's attention scores reach ~200 and float32
    rounding (other on the card than on the CPU) moves its grads by up
    to 3e-2 of a leaf's max (tests/test_torch_loss.py), and full-depth
    smollm-360m's gradient norm is ~1e17, so the clipped grads (norm 1)
    fall far below AdamW's eps and no step moves the loss."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        dt = getattr(torch, t.dtype or cfg.dtype)
        if t.init in ("zeros", "ones"):
            return torch.full(t.shape, float(t.init == "ones"), dtype=dt,
                              device=dev)
        scale = (gain / math.sqrt(t.shape[-2]) if t.init == "fan_in"
                 else t.scale)
        return (scale * torch.randn(t.shape, generator=g,
                                    device=dev)).to(dt)
    return walk(bridge.param_specs(cfg))


def train_card_vs_cpu(torch, T, bridge, configs, zoo,
                      archs=TRAIN_CHECK_ARCHS):
    """One ``make_train_step`` step of each reduced float32 family on the
    card and on the CPU, same parameters and batch ("vision" for the
    VLM, "frames" for whisper), lr 3e-3 from step 0: loss and grad norm
    within TRAIN_RTOL, every updated parameter within 2.1 lr (an Adam
    step on a gradient near 0 is +-lr either way), and the count of
    entries whose update has another sign."""
    import dataclasses
    out = {}
    for arch in archs:
        cfg = dataclasses.replace(configs.reduced(configs.ARCHS[arch]),
                                  dtype="float32")
        params = train_params(torch, bridge, cfg, 0)
        g = torch.Generator().manual_seed(1)
        S = cfg.max_target_len if cfg.encoder_decoder else 32
        toks = torch.randint(0, cfg.vocab_size, (2, S + 1), generator=g,
                             dtype=torch.int32)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if cfg.cross_attn_period and not cfg.encoder_decoder:
            batch["vision"] = torch.randn(2, cfg.n_vision_tokens,
                                          cfg.d_model, generator=g)
        if cfg.encoder_decoder:
            batch["frames"] = torch.randn(2, 20, cfg.d_model, generator=g)
        tc = T.TrainConfig(adamw=T.AdamWConfig(lr=3e-3), warmup_steps=0,
                           total_steps=10)
        step = T.make_train_step(zoo.build(cfg), tc)
        res = {}
        for dev in ("cpu", "cuda"):
            state = T.init_state(bridge.tree_to(params, dev), tc)
            new, m = step(state, {k: v.to(dev) for k, v in batch.items()})
            res[dev] = (flat_leaves(new.params), m)
        (pc, mc), (pg, mg) = res["cpu"], res["cuda"]
        lr = float(mc["lr"])
        rel = {k: abs(float(mg[k]) - float(mc[k])) / abs(float(mc[k]))
               for k in ("loss", "grad_norm")}
        check(all(v <= TRAIN_RTOL for v in rel.values()),
              f"train {arch}: card vs CPU {rel}")
        old = flat_leaves(params)
        worst, flips = 0.0, 0
        for k, x in pc.items():
            y = pg[k].cpu()
            worst = max(worst, (x - y).abs().max().item())
            flips += int((torch.sign(x - old[k])
                          != torch.sign(y - old[k])).sum())
        check(worst <= 2.1 * lr, f"train {arch}: parameters {worst / lr:.3g}"
              " lr apart")
        out[arch] = dict(loss=float(mc["loss"]), rel=rel,
                         max_param_diff_in_lr=worst / lr,
                         sign_differing_updates=flips,
                         params=sum(x.numel() for x in pc.values()))
    print("train: reduced float32 card == CPU (loss and grad norm within "
          f"{TRAIN_RTOL}, parameters within 2.1 lr): " + json.dumps(out))
    return out


def train_phase(torch, configs, bridge, zoo, dev="cuda", cfg=None,
                seq=TRAIN_SEQ, cli_extra=()):
    """smollm-360m trained at full width and depth (``train_full_width``),
    each switch at full width (``train_switches``), the train CLI with a
    checkpoint and a resume (``train_cli``) and, on the card, one step
    of six reduced float32 families card == CPU
    (``train_card_vs_cpu``). Rehearses on the CPU with ``dev="cpu"``, a
    reduced ``cfg`` and ``cli_extra=["--reduced"]``."""
    from repro_torch import train as T
    from repro_torch.launch import train as tcli
    from repro_torch.train import checkpoint as ckpt
    if cfg is None:
        cfg = configs.get_config("smollm-360m")
        check(all(getattr(cfg, k) == v for k, v in TRAIN_WIDTH.items()),
              "smollm-360m is not at full width")
    card = card_line() if dev == "cuda" else "cpu"
    api = zoo.build(cfg)
    params, b = train_full_width(torch, T, tcli, bridge, api, dev, card,
                                 seq=seq)
    train_switches(torch, T, api, params, b, dev)
    del params, b
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()
    train_cli(torch, T, tcli, ckpt, configs, zoo, dev, cli_extra)
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()
        train_card_vs_cpu(torch, T, bridge, configs, zoo)


# ---------------------------------------------------------------------------
# sharded training over emulated meshes
# ---------------------------------------------------------------------------

SHARD_MESHES = ((2, 1), (4, 1), (2, 2))
SHARD_BF16_MESH = (4, 1)
SHARD_BF16_STEPS = 3
SHARD_CLI = ["--shards", "2", "--steps", "3"]


def shard_mesh(M, shape, dev):
    return M.make_mesh(*shape, devices=[dev] * (shape[0] * shape[1]))


def shard_state_bytes(shards):
    """Bytes of each shard's state."""
    return [tree_bytes(s.as_dict()) for s in shards]


def shard_rel(a, b):
    """|a - b| / |b| of each entry of two equal-length lists."""
    return [abs(x - y) / abs(y) for x, y in zip(a, b)]


def shard_f32_check(torch, T, SH, M, bridge, api, batch, dev):
    """One float32 step of ``api``'s model from the same parameters
    (``train_params``, seed 0) and batch on each of SHARD_MESHES, every
    shard on ``dev``, against two one-device ``make_train_step`` steps:
    the plain one (grad_accum 1) and the one over the same rows
    (grad_accum = the mesh's data rows: microbatches of the rows each
    data shard takes, the same products). Against the same rows the
    loss and grad norm must be within TRAIN_RTOL and every parameter
    within 2.1 lr (``train_card_vs_cpu``'s tolerances); against the
    plain step the loss within TRAIN_RTOL, the parameters within 2.1 lr
    and the grad norm no further than the one-device same-rows step is
    from it, plus TRAIN_RTOL (at full depth the model's float32 grads
    move with the rows' product shapes: that gap is the model's, on one
    device). Each mesh's step wall, peak memory and per-shard state
    bytes."""
    def tc(accum):
        return T.TrainConfig(adamw=T.AdamWConfig(lr=3e-3), warmup_steps=0,
                             total_steps=10, grad_accum=accum)
    params = train_params(torch, bridge, api.cfg, 0, dev)
    state = T.init_state(params, tc(1))
    out, one = {}, {}
    for accum in sorted({1} | {shape[0] for shape in SHARD_MESHES}):
        sync(torch, dev)
        if dev == "cuda":
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        ref, m = T.make_train_step(api, tc(accum))(state, batch)
        sync(torch, dev)
        one[accum] = ([float(m[k]) for k in ("loss", "grad_norm")],
                      flat_leaves(ref.params), float(m["lr"]))
        out[f"one_device_accum{accum}"] = dict(
            wall_s=time.perf_counter() - t0, loss=one[accum][0][0],
            grad_norm=one[accum][0][1])
        if dev == "cuda":
            out[f"one_device_accum{accum}"]["peak_gib"] = \
                torch.cuda.max_memory_allocated() / 2 ** 30
        del ref
    out["one_device_state_bytes"] = tree_bytes(state.as_dict())
    del state
    for shape in SHARD_MESHES:
        mesh = shard_mesh(M, shape, dev)
        step = SH.make_sharded_train_step(api, tc(1), mesh)
        shards = SH.init_sharded_state(params, step.sharding, tc(1))
        gc.collect()
        if dev == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        new, m = step(shards, batch)
        sync(torch, dev)
        wall = time.perf_counter() - t0
        got_m = [float(m[k]) for k in ("loss", "grad_norm")]
        got = flat_leaves(SH.unshard_state(new, step.sharding).params)
        name = f"{shape[0]}x{shape[1]}"
        row = dict(wall_s=wall, shard_state_bytes=shard_state_bytes(shards))
        for label, accum in (("same_rows", shape[0]), ("plain", 1)):
            want_m, want, lr = one[accum]
            rel = shard_rel(got_m, want_m)
            worst = max((got[k] - want[k]).abs().max().item() for k in want)
            row[label] = dict(accum=accum, rel_loss=rel[0],
                              rel_grad_norm=rel[1],
                              max_param_diff_in_lr=worst / lr)
            check(worst <= 2.1 * lr, f"sharded train {name}: parameters "
                  f"{worst / lr:.3g} lr from the one-device {label} step")
            check(rel[0] <= TRAIN_RTOL, f"sharded train {name}: loss "
                  f"{rel[0]:.3g} from the one-device {label} step")
        split = shard_rel(one[shape[0]][0], one[1][0])[1]
        row["one_device_split_rel_grad_norm"] = split
        check(row["same_rows"]["rel_grad_norm"] <= TRAIN_RTOL,
              f"sharded train {name}: grad norm vs the same rows {row}")
        check(row["plain"]["rel_grad_norm"] <= split + TRAIN_RTOL,
              f"sharded train {name}: grad norm vs one device {row}")
        if dev == "cuda":
            row["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        out[name] = row
        del shards, new, got
    print("sharded train: float32 full-width step on each mesh against one "
          f"device (tolerance {TRAIN_RTOL} relative, parameters within 2.1 "
          "lr): " + json.dumps(out))
    return out


def shard_collectives(torch, T, SH, M, dry, bridge, api, batch, dev, shape):
    """The collectives of one TrainConfig() step on ``shape`` under a
    ``counting.Counter`` (per device: the totals over the mesh's
    shards), beside ``dryrun.rule_collectives``' entries for the same
    config, batch and mesh (meta shapes)."""
    from repro_torch.analysis import counting
    from repro_torch.configs import ShapeSpec
    tc = T.TrainConfig()
    mesh = shard_mesh(M, shape, dev)
    step = SH.make_sharded_train_step(api, tc, mesh)
    shards = SH.init_sharded_state(train_params(torch, bridge, api.cfg, 0,
                                                dev), step.sharding, tc)
    with counting.Counter() as c:
        step(shards, batch)
        sync(torch, dev)
    del shards
    B, S = batch["tokens"].shape
    cell = dry.build_cell(api.cfg, ShapeSpec("train", S, B, "train"),
                          mesh=shard_mesh(M, shape, "meta"),
                          overrides=dict(grad_accum=1, quant_moments=False))
    with dry.applied(cell.layout):
        rule = dry.rule_collectives(cell)
    n = mesh.size
    issued = {k: dict(bytes_per_device=v / n,
                      count_per_device=c.collective_counts[k] / n)
              for k, v in sorted(c.collective_bytes.items())}
    by_src = {}
    for r in rule:
        e = by_src.setdefault(f"{r['source']} ({r['kind']})",
                              dict(bytes_per_device=0, count=0))
        e["bytes_per_device"] += r["bytes"]
        e["count"] += r["count"]
    grad = {r["kind"]: 0 for r in rule if r["source"] == "gradient reduce"}
    for r in rule:
        if r["source"] == "gradient reduce":
            grad[r["kind"]] += r["bytes"]
    rs = issued.get("reduce-scatter", {}).get("bytes_per_device", 0)
    check(rs == grad.get("reduce-scatter", 0),
          f"sharded train {shape}: reduce-scatter {rs} B a device, the rule "
          f"{grad.get('reduce-scatter', 0)}")
    return dict(issued=issued, rule=by_src)


def shard_bf16_run(torch, T, SH, M, bridge, api, batches, dev):
    """SHARD_BF16_STEPS steps of TrainConfig() on SHARD_BF16_MESH beside
    the one-device steps from the same parameters, plain and over the
    same rows (grad_accum = the mesh's data rows). Tolerance, stated
    before the run: each loss within BF16_REL relative of the plain
    one-device step's, each loss and grad norm within BF16_REL of the
    same-rows step's (the shards round their summed bfloat16 grads once
    more), each grad norm no further from the plain step's than the
    same-rows step is, plus BF16_REL. Walls, peak memory, per-shard and
    one-device state bytes. Returns the sharded state, its step and the
    figures."""
    params = train_params(torch, bridge, api.cfg, 0, dev)
    rows = SHARD_BF16_MESH[0]
    print(f"sharded train: bf16 {SHARD_BF16_MESH} against one device, "
          f"tolerance {BF16_REL} relative (loss against the plain step; "
          f"loss and grad norm against grad_accum {rows})")
    out, res = {}, {}
    mesh = shard_mesh(M, SHARD_BF16_MESH, dev)
    for name in ("one_device", f"one_device_accum{rows}", "sharded"):
        tc = T.TrainConfig(grad_accum=1 if name != f"one_device_accum{rows}"
                           else rows)
        if name == "sharded":
            step = SH.make_sharded_train_step(api, tc, mesh)
            state = SH.init_sharded_state(params, step.sharding, tc)
        else:
            step = T.make_train_step(api, tc)
            state = T.init_state(params, tc)
        gc.collect()
        if dev == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        got, walls = [], []
        for b in batches:
            t0 = time.perf_counter()
            state, m = step(state, b)
            sync(torch, dev)
            walls.append(time.perf_counter() - t0)
            got.append([float(m["loss"]), float(m["grad_norm"])])
            print(f"sharded train: bf16 {name} step {len(got)} "
                  f"loss={got[-1][0]:.6f} gnorm={got[-1][1]:.6g} "
                  f"wall={walls[-1] * 1e3:.1f} ms")
        out[name] = dict(losses=[r[0] for r in got],
                         grad_norms=[r[1] for r in got], walls_s=walls)
        if dev == "cuda":
            out[name]["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        if name == "sharded":
            out[name]["shard_state_bytes"] = shard_state_bytes(state)
            res[name] = (state, step, got)
        else:
            out[name]["state_bytes"] = tree_bytes(state.as_dict())
            res[name] = (None, None, got)
        del state
    plain, same, sh = (res[k][2] for k in ("one_device",
                                           f"one_device_accum{rows}",
                                           "sharded"))
    for p, q, x in zip(plain, same, sh):
        check(all(math.isfinite(v) for v in x),
              f"sharded train bf16: {x} not finite")
        check(shard_rel(x, p)[0] <= BF16_REL
              and max(shard_rel(x, q)) <= BF16_REL
              and shard_rel(x, p)[1] <= shard_rel(q, p)[1] + BF16_REL,
              f"sharded train bf16: {x} against one device {p} and the "
              f"same rows {q}")
    print("sharded train: bf16 " + json.dumps(out))
    return res["sharded"][0], res["sharded"][1], out


def shard_elastic(torch, T, SH, M, ckpt, api, shards, step4, b, dev):
    """Save the SHARD_BF16_MESH state, restore it onto (2, 1) and onto
    one device: every restored leaf bit-equal to the saved state's own
    block; then one more step on each mesh from the restored state
    against the same step from the saved state laid out on that mesh
    (loss and grad norm within one bf16 ulp relative, parameters within
    one bf16 ulp plus 2.1 lr: the embedding's backward accumulates with
    atomics on the card, so the grads need not be bit-equal)."""
    import tempfile
    (ROOT / "build").mkdir(exist_ok=True)
    tc = T.TrainConfig()
    out = {}
    whole = SH.unshard_state(shards, step4.sharding)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        t0 = time.perf_counter()
        ckpt.save_checkpoint(d, [s.as_dict() for s in shards],
                             int(shards[0].step), shardings=step4.sharding)
        out["save_s"] = time.perf_counter() - t0
        out["checkpoint_bytes"] = tree_bytes(whole.as_dict())
        for name, shape in (("2x1", (2, 1)), ("1x1", (1, 1))):
            step = SH.make_sharded_train_step(api, tc,
                                              shard_mesh(M, shape, dev))
            t0 = time.perf_counter()
            back = [T.TrainState.from_dict(x) for x in
                    ckpt.restore_checkpoint(d, shardings=step.sharding)]
            sync(torch, dev)
            restore_s = time.perf_counter() - t0
            want = SH.shard_state(whole, step.sharding)
            for got, w in zip(back, want):
                a, r = flat_leaves(got.as_dict()), flat_leaves(w.as_dict())
                check(set(a) == set(r), f"elastic {name}: paths differ")
                for k in a:
                    check(a[k].dtype == r[k].dtype and torch.equal(a[k], r[k]),
                          f"elastic {name}: restored leaf {k} differs")
            sa, ma = step(want, b)
            del want
            sr, mr = step(back, b)
            lr = float(ma["lr"])
            rel = {k: abs(float(ma[k]) - float(mr[k])) / float(ma[k])
                   for k in ("loss", "grad_norm")}
            check(all(v <= BF16_REL for v in rel.values()),
                  f"elastic {name}: the next step's {rel} relative")
            pa = flat_leaves(SH.unshard_state(sa, step.sharding).params)
            pr = flat_leaves(SH.unshard_state(sr, step.sharding).params)
            use = max(((pa[k].float() - pr[k].float()).abs()
                       / (BF16_REL * pa[k].float().abs() + 2.1 * lr))
                      .max().item() for k in pa)
            check(use <= 1.0, f"elastic {name}: next step {use:.3g} x the "
                  "bf16 bound")
            out[name] = dict(restore_s=restore_s, next_step_rel=rel,
                             share_of_bound=use, shards=len(back),
                             params_differ=sum(int((pa[k] != pr[k]).sum())
                                               for k in pa))
            del back, sa, sr, pa, pr
    del whole
    print("sharded train: elastic restore " + json.dumps(out))
    return out


def shard_cli(torch, T, tcli, dev, extra=()):
    """The train CLI over a host mesh of 2 shards (SHARD_CLI, a
    checkpoint at its end), then a resume at one shard to step 5."""
    import tempfile
    (ROOT / "build").mkdir(exist_ok=True)
    out = {}
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        for args in (SHARD_CLI, ["--shards", "1", "--steps", "5"]):
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                state = tcli.main(TRAIN_CLI + ["--device", dev, "--ckpt-dir",
                                               d] + args + list(extra))
            out[" ".join(args)] = time.perf_counter() - t0
            text = buf.getvalue()
            print("".join(f"sharded train: cli: {line}\n"
                          for line in text.splitlines()), end="")
            check(int(state.step) == int(args[-1]),
                  f"sharded train cli: step {state.step}")
            del state
        check("resumed from step 3" in text,
              "sharded train cli: the one-shard call did not resume")
    print("sharded train: cli walls " + json.dumps(out))
    return out


def sharded_train_phase(torch, configs, bridge, zoo, dev="cuda", cfg=None,
                        seq=TRAIN_SEQ, cli_extra=()):
    """smollm-360m at full width and depth (TRAIN_WIDTH) trained over
    meshes emulated on one device: the float32 step on SHARD_MESHES
    against one device (``shard_f32_check``), the bf16 steps on
    SHARD_BF16_MESH beside one device (``shard_bf16_run``), the
    collectives of a step beside the dry-run's rule
    (``shard_collectives``), the elastic restore (``shard_elastic``) and
    the CLI (``shard_cli``). Rehearses on the CPU with ``dev="cpu"``, a
    reduced ``cfg`` and ``cli_extra=["--reduced"]``."""
    import dataclasses
    from repro_torch import train as T
    from repro_torch.launch import dryrun as dry
    from repro_torch.launch import mesh as M
    from repro_torch.launch import train as tcli
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import sharded as SH
    if cfg is None:
        cfg = configs.get_config("smollm-360m")
        check(all(getattr(cfg, k) == v for k, v in TRAIN_WIDTH.items()),
              "smollm-360m is not at full width")
    data = tcli.synthetic_batches(cfg.vocab_size, TRAIN_BATCH, seq, seed=0,
                                  device=dev)
    batches = [next(data) for _ in range(SHARD_BF16_STEPS + 1)]
    api32 = zoo.build(dataclasses.replace(cfg, dtype="float32"))
    t0 = time.perf_counter()
    f32 = shard_f32_check(torch, T, SH, M, bridge, api32, batches[0], dev)
    del api32
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()
    api = zoo.build(cfg)
    colls = {f"{s[0]}x{s[1]}": shard_collectives(
        torch, T, SH, M, dry, bridge, api, batches[0], dev, s)
        for s in (SHARD_BF16_MESH, (2, 2))}
    print("sharded train: collectives of a TrainConfig() step (issued, per "
          "device) beside dryrun.rule_collectives " + json.dumps(colls))
    shards, step4, bf16 = shard_bf16_run(
        torch, T, SH, M, bridge, api, batches[:SHARD_BF16_STEPS], dev)
    elastic = shard_elastic(torch, T, SH, M, ckpt, api, shards, step4,
                            batches[-1], dev)
    del shards
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()
    cli = shard_cli(torch, T, tcli, dev, cli_extra)
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()
    print(f"sharded train: phase took {time.perf_counter() - t0:.1f}s")
    return dict(f32=f32, collectives=colls, bf16=bf16, elastic=elastic,
                cli=cli)


# ---------------------------------------------------------------------------
# the dry-run and its roofline
# ---------------------------------------------------------------------------

DRY_META_CELLS = (("smollm-360m", "train_4k"), ("smollm-360m", "prefill_32k"),
                  ("smollm-360m", "decode_32k"), ("mixtral-8x22b", "train_4k"),
                  ("mixtral-8x22b", "decode_32k"))
# cuts of depth for meta cells whose whole count takes minutes on the
# host (mixtral's half-expert train step loops over 256 shards a layer):
# layers kept, of the config's
DRY_META_LAYERS = {("mixtral-8x22b", "train_4k"): 4}
DRY_REPS, DRY_WARMUP = 5, 1


def dry_cuts():
    """smollm-360m's cells cut to one H100: the training phase's batch,
    one 32768-token prefill, and 8 lanes decoding against a full
    32768-token cache (~10.7 GB of bf16 KV) through the split-K
    kernel."""
    from repro_torch.configs import ShapeSpec
    return (ShapeSpec("train_8x1024", 1024, 8, "train"),
            ShapeSpec("prefill_1x32768", 32768, 1, "prefill"),
            ShapeSpec("decode_8x32768", 32768, 8, "decode"))


def dry_list(dry):
    """``--list`` through the port: 33 RUN and 7 SKIP lines."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        check(dry.main(["--list"]) == 0, "dryrun --list failed")
    lines = buf.getvalue().splitlines()
    runs = sum(" RUN" in x for x in lines)
    skips = sum(" SKIP: " in x for x in lines)
    print(f"dryrun: --list {len(lines)} cells, {runs} RUN, {skips} SKIP")
    check((runs, skips) == (33, 7), f"dryrun --list: {runs} RUN, {skips} "
          "SKIP, expected 33 and 7")


def dry_meta_cells(dry, configs):
    """The meta dry-run of DRY_META_CELLS on the one-pod mesh (16, 16):
    each record's roofline row and its count wall."""
    import dataclasses
    from repro_torch.analysis import roofline_report
    for arch, shape in DRY_META_CELLS:
        cfg = configs.get_config(arch)
        keep = DRY_META_LAYERS.get((arch, shape))
        if keep:
            cfg = dataclasses.replace(cfg, n_layers=keep)
        t0 = time.perf_counter()
        rec = dry.run_cell(cfg, shape)
        wall = time.perf_counter() - t0
        cnt = rec["count"]
        check(cnt["dot_flops"] > 0 and rec["memory"]["argument_bytes"] > 0,
              f"dryrun {arch} {shape}: nothing counted")
        out = dict(roofline_report.rows_from([rec])[0], mesh=rec["mesh"],
                   layers=f"{cfg.n_layers} of "
                   f"{configs.get_config(arch).n_layers}",
                   count_wall_s=wall, dot_flops=cnt["dot_flops"],
                   dot_bytes=cnt["dot_bytes"],
                   collective_bytes=cnt["collective_bytes"],
                   kernels={k: v["calls"] for k, v in cnt["kernels"].items()},
                   extra=rec["extra"])
        print("dryrun: meta " + json.dumps(out))


def dry_profile(torch, cell):
    """One more step of ``cell`` under torch.profiler (device activity):
    its wall, device busy ms and share, launches and the split-K
    kernel's device time a call. Instrumentation only."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        cell.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = device_kernels(torch, prof)
    busy_ms = sum(k[0] for k in kernels) / 1e3
    if busy_ms == 0.0:
        return "not measured (the profiler recorded no device time)"
    split = [k for k in kernels if "dense_split_kernel" in k[2]]
    return dict(wall_ms=wall * 1e3, device_busy_ms=busy_ms,
                device_busy_share=busy_ms / (wall * 1e3),
                launches=sum(k[1] for k in kernels),
                split_k_ms_a_call=(split[0][0] / 1e3 / split[0][1]
                                   if split else None),
                top=[dict(kernel=k[2][:60], ms=k[0] / 1e3, calls=k[1])
                     for k in kernels[:5]])


def dry_decode_kernel(torch, cell, flush):
    """The split-K kernel at the decode cut's shape (first layer's cache
    through the model layout's transposed views, every lane full), held
    against its plain version and timed beside its bound and SDPA."""
    DAK = importlib.import_module("repro_torch.kernels.decode_attention")
    from repro_torch.analysis import counting
    cfg = cell.cfg
    k, v = (cell.args[1]["p0"][n][0] for n in ("k", "v"))
    B, S, KH, D = k.shape
    g = torch.Generator(device="cuda").manual_seed(5)
    k.copy_(rand(torch, g, k.dtype, *k.shape))
    v.copy_(rand(torch, g, v.dtype, *v.shape))
    q = rand(torch, g, k.dtype, B, cfg.n_heads, D)
    lens = torch.full((B,), S, dtype=torch.int32, device="cuda")
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
    flops, bytes_ = counting.decode_cost(q, kt, lens)
    G = cfg.n_heads // KH
    kg, vg = kt.repeat_interleave(G, 1), vt.repeat_interleave(G, 1)
    return measure_row(
        torch, {}, flush, "decode", "smollm-360m dry-run decode cut",
        lambda: DAK.decode_attention(q, kt, vt, lens),
        lambda: DAK.decode_attention_plain(q, kt, vt, lens),
        lambda: torch.nn.functional.scaled_dot_product_attention(
            q[:, :, None], kg, vg)[:, :, 0],
        bytes_, flops, plain_n=3, library_n=10)


def dry_card_cut(torch, dry, mesh_mod, cut, card, cfg="smollm-360m",
                 dev="cuda"):
    """One cut of ``cfg`` (full-width smollm-360m) on a 1 x 1 mesh on the
    card: the dot FLOPs, dot bytes and kernels counted on the card must
    equal the meta count of the same cut exactly; then the step's wall
    (CUDA events, DRY_REPS after DRY_WARMUP, without the counter), the
    model-FLOP share, the roofline bound over the wall and peak memory
    against the argument bytes. Rehearses on the CPU with ``dev="cpu"``
    and a reduced ``cfg`` (host clock, no memory figures; the split-K
    launch count is then bumped by a wrapper of the caller's)."""
    from repro_torch.analysis import roofline
    DAK = importlib.import_module("repro_torch.kernels.decode_attention")
    meta = dry.count_cell(dry.build_cell(
        cfg, cut, mesh=mesh_mod.make_mesh(1, 1, ["meta"]), device="meta"))
    cell = dry.build_cell(cfg, cut, mesh=mesh_mod.make_mesh(1, 1, [dev]),
                          device=dev)
    sync(torch, dev)
    DAK.decode_attention.launches = 0
    t0 = time.perf_counter()
    c = dry.count_cell(cell)
    rec = dry.record(cell, c, time.perf_counter() - t0)
    got = (c.dot_flops, c.dot_bytes, c.kernels)
    want = (meta.dot_flops, meta.dot_bytes, meta.kernels)
    check(got == want, f"dryrun {cut.name}: card count {got[:2]} != meta "
          f"count {want[:2]}")
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    for _ in range(DRY_WARMUP):
        cell.step()
    walls = []
    for _ in range(DRY_REPS):
        if dev != "cuda":
            t0 = time.perf_counter()
            cell.step()
            walls.append(time.perf_counter() - t0)
            continue
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        cell.step()
        b.record()
        b.synchronize()
        walls.append(a.elapsed_time(b) / 1e3)
    launches = DAK.decode_attention.launches
    steps = 1 + DRY_WARMUP + DRY_REPS
    want_launches = (cell.cfg.n_layers * steps if cut.kind == "decode"
                     else 0)
    check(launches == want_launches, f"dryrun {cut.name}: {launches} "
          f"split-K launches, expected {want_launches}")
    wall = spread(walls)
    prof = dry_profile(torch, cell) if dev == "cuda" else "not measured"
    mf = rec["model"]["model_flops"]
    t = roofline.roofline_from_record(rec, mf)
    out = dict(cut=cut.name, B=cut.global_batch, S=cut.seq_len,
               kind=cut.kind, dot_flops=c.dot_flops, dot_bytes=c.dot_bytes,
               kernels=c.kernels, count_equal_to_meta=True,
               split_k_launches=launches, step_wall_s=wall,
               model_flops=mf,
               model_flop_share=mf / (wall["median"] * roofline.PEAK_FLOPS),
               useful=t.useful_ratio, roofline_bound_s=t.step_time_s,
               roofline_bound_by=t.dominant,
               roofline_share=t.step_time_s / wall["median"],
               peak_gib=(torch.cuda.max_memory_allocated() / 2 ** 30
                         if dev == "cuda" else "not measured"),
               argument_gib=rec["memory"]["argument_bytes"] / 2 ** 30,
               profile=prof, card=card)
    print("dryrun: card " + json.dumps(out))
    if dev == "cuda" and cut.kind == "decode":
        flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
        out["kernel_row"] = dry_decode_kernel(torch, cell, flush)
    del cell
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()
    return out


def dryrun_phase(torch, configs):
    """``--list`` through the port, the meta dry-run of DRY_META_CELLS
    and the three smollm-360m cuts on the card (``dry_card_cut``)."""
    from repro_torch.launch import dryrun as dry
    from repro_torch.launch import mesh as mesh_mod
    card = card_line()
    dry_list(dry)
    dry_meta_cells(dry, configs)
    for cut in dry_cuts():
        dry_card_cut(torch, dry, mesh_mod, cut, card)
    print(f"dryrun: card {card}")


# ---------------------------------------------------------------------------
# the three examples of examples/torch/
# ---------------------------------------------------------------------------

EXAMPLES = ROOT / "examples" / "torch"
EX_STEPS = 120          # the train example's default --steps
EX_PROMPT, EX_SHARED = 36, 30       # the quickstart's prompt, its system part


def load_example(name):
    """``examples/torch/<name>.py`` as a module of its own."""
    spec = importlib.util.spec_from_file_location(f"torch_example_{name}",
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def relative_ids(lines):
    """"req <id>:" as the offset from the first printed id (request ids
    come from a process-wide counter)."""
    ids = [int(m) for m in re.findall(r"^req (\d+):", "\n".join(lines),
                                      re.MULTILINE)]
    return [re.sub(r"^req (\d+):", lambda m: f"req +{int(m[1]) - ids[0]}:",
                   ln) for ln in lines]


def peak_gib(torch, dev):
    return (torch.cuda.max_memory_allocated() / 2 ** 30 if dev == "cuda"
            else None)


def reset_peak(torch, dev):
    sync(torch, dev)
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()


def ex_quickstart(torch, PA, configs, bridge, qs, cfg, params, dev):
    """The quickstart at its own size (its main), in float32 at that size
    card == CPU line for line, and at ``cfg``'s width with the example's
    EngineConfig and 8 requests: reuse, cached counts and launches."""
    import dataclasses
    print("examples: quickstart at its own size (reduced, bf16):")
    qs.main(["--device", dev])
    small = dataclasses.replace(
        configs.reduced(configs.get_config("smollm-360m")), dtype="float32")
    p32 = bridge.init_params(small, torch.Generator().manual_seed(0), "cpu")
    cpu = relative_ids(qs.run(small, "cpu", p32)["lines"])
    card = relative_ids(qs.run(small, dev, bridge.tree_to(p32, dev))["lines"])
    check(card == cpu, f"quickstart float32: card {card} != CPU {cpu}")
    print(f"examples: quickstart float32 reduced, card == CPU on all "
          f"{len(cpu)} lines, output tokens included")

    reset_peak(torch, dev)
    PA.paged_decode_attention.launches = 0
    t0 = time.perf_counter()
    res = qs.run(cfg, dev, params)
    sync(torch, dev)
    wall = time.perf_counter() - t0
    launches = PA.paged_decode_attention.launches
    print("\n".join(res["lines"]))
    done = sorted(res["done"], key=lambda r: r.request_id)
    eng = res["engine"]
    disp = eng.stats["model_dispatches"]
    check(res["saved"] > 0.4, f"quickstart saved {res['saved']}")
    check(len(done) == 8 and all(r.prompt_len == EX_PROMPT for r in done)
          and [r.cached_len for r in done[1:]] == [EX_SHARED] * 7,
          "quickstart: cached "
          f"{[(r.cached_len, r.prompt_len) for r in done]}")
    check_outputs("quickstart", done, cfg.vocab_size)
    check(launches > 0 and launches == cfg.n_layers * disp,
          f"quickstart: paged launches {launches} != {cfg.n_layers} x "
          f"{disp} dispatches")
    print("examples: quickstart " + json.dumps(dict(
        layers=cfg.n_layers, d_model=cfg.d_model, dtype=cfg.dtype,
        wall_s=wall, saved=res["saved"], engine_steps=eng.stats["iterations"],
        model_dispatches=disp, paged_launches=launches,
        peak_mem_gib=peak_gib(torch, dev))))


def ex_distributed(torch, PA, ds, cfg, params, dev):
    """The distributed example at ``cfg``'s width: 4 instances on the one
    device, E2 then round-robin, then the failover; launches = layers x
    the dispatches of all eight engines."""
    reset_peak(torch, dev)
    PA.paged_decode_attention.launches = 0
    t0 = time.perf_counter()
    res = ds.run(cfg, dev, params)
    sync(torch, dev)
    wall = time.perf_counter() - t0
    launches = PA.paged_decode_attention.launches
    print("\n".join(res["lines"]))
    out, disp = {}, 0
    for policy, r in res["results"].items():
        cl = r["cluster"]
        disp += sum(e.stats["model_dispatches"] for e in cl.engines.values())
        check(r["done"] == 24, f"distributed {policy}: {r['done']}/24")
        check_outputs(f"distributed {policy}", cl.finished, cfg.vocab_size)
        out[policy] = dict(finished=r["done"], prefill_saved=r["reuse_frac"],
                           avg_s=r["avg_lat"], p99_s=r["p99_lat"],
                           host_wall_s=r["wall"])
    e2, rr = res["results"]["e2"], res["results"]["rr"]
    check(e2["reuse_frac"] >= rr["reuse_frac"], "distributed: E2 < RR")
    check(all(r.state.value == "finished" for r in res["extra"]),
          "distributed: an extra request did not finish")
    check(launches > 0 and launches == cfg.n_layers * disp,
          f"distributed: paged launches {launches} != {cfg.n_layers} x "
          f"{disp} dispatches")
    print("examples: distributed " + json.dumps(dict(
        layers=cfg.n_layers, d_model=cfg.d_model, policies=out,
        e2_at_least_rr=True, rerouted=res["rerouted"],
        extra_finished=len(res["extra"]), wall_s=wall,
        model_dispatches=disp, paged_launches=launches,
        peak_mem_gib=peak_gib(torch, dev))))


def ex_train_row(torch, res, batch, seq, dev):
    """first / final loss, the restored step, step wall (median and
    spread of the 20-step spans), tokens/s, peak and checkpoint bytes."""
    check(res["restored_step"] == res["half"],
          f"train: restored step {res['restored_step']} != {res['half']}")
    s = spread(res["step_s"]) if res["step_s"] else None
    return dict(first_loss=res["first_loss"], final_loss=res["final"],
                restored_step=res["restored_step"], step_s=s,
                tokens_per_s=batch * seq / s["median"] if s else None,
                peak_mem_gib=peak_gib(torch, dev),
                ckpt_bytes=res["ckpt_bytes"])


def ex_train(torch, bridge, tt, dev, steps):
    """The train example's default variant and ``--full`` (12 layers at
    smollm-360m's width, 8 x 512) through its main, at ``steps`` steps;
    then ``--full`` through its ``run`` with parameters drawn at
    TRAIN_FAN_IN_GAIN. Under the reference's scale the 12-layer stack's
    loss stays flat (its assertion holds on the batches, not on
    training: PERF.md, ROADMAP queue 3); at the gain it trains."""
    for flags in ([], ["--full"]):
        reset_peak(torch, dev)
        print(f"examples: train_smollm {' '.join(flags) or 'default'}:")
        res = tt.main(flags + ["--steps", str(steps), "--device", dev])
        cfg, batch, seq = tt.variant(bool(flags))
        print(f"examples: train {' '.join(flags) or 'default'} "
              + json.dumps(dict(
                  layers=cfg.n_layers, d_model=cfg.d_model, batch=batch,
                  seq=seq, steps=steps,
                  **ex_train_row(torch, res, batch, seq, dev))))
        del res
        gc.collect()

    cfg, batch, seq = tt.variant(True)
    params = train_params(torch, bridge, cfg, 0, dev)
    reset_peak(torch, dev)
    print(f"examples: train_smollm --full through run, parameters drawn at "
          f"{TRAIN_FAN_IN_GAIN} of the reference's fan_in scale:")
    res = tt.run(cfg, dev, steps, batch, seq, params=params)
    del params
    print("\n".join(res["lines"]))
    print("examples: train --full at the gain " + json.dumps(dict(
        layers=cfg.n_layers, d_model=cfg.d_model, batch=batch, seq=seq,
        steps=steps, fan_in_gain=TRAIN_FAN_IN_GAIN,
        **ex_train_row(torch, res, batch, seq, dev))))


def examples_phase(torch, PA, configs, bridge, dev="cuda", cfg=None,
                   steps=EX_STEPS, full=None):
    """The three examples of ``examples/torch/`` on the card: the
    quickstart (its own size, float32 card == CPU, and ``cfg``, by
    default smollm-360m at full width and depth), distributed serving at
    ``cfg`` and the train example's default variant and ``--full``.
    Rehearses on the CPU with ``dev="cpu"``, a reduced ``cfg``, a
    small ``full`` (cfg, batch, seq) in place of ``--full``'s and the
    paged kernel's count bumped by a wrapper."""
    qs, ds, tt = (load_example(n) for n in ("quickstart",
                                            "distributed_serving",
                                            "train_smollm"))
    if full is not None:
        tt.variant = lambda f, small=tt.variant(False): full if f else small
    if cfg is None:
        cfg = configs.get_config("smollm-360m")
        check(all(getattr(cfg, k) == v for k, v in TRAIN_WIDTH.items()),
              "smollm-360m is not at full width")
    t0 = time.perf_counter()
    params = bridge.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev)
    ex_quickstart(torch, PA, configs, bridge, qs, cfg, params, dev)
    ex_distributed(torch, PA, ds, cfg, params, dev)
    del params
    gc.collect()
    t1 = time.perf_counter()
    ex_train(torch, bridge, tt, dev, steps)
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()
    print(f"examples: serving took {t1 - t0:.1f}s, training "
          f"{time.perf_counter() - t1:.1f}s")


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke run needs an NVIDIA GPU")
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"run from the root of a checkout: {SRC / 'repro_torch'} "
             "is missing")
    sys.path.insert(0, str(SRC))
    from repro_torch import bridge, configs, full_precision_matmuls
    from repro_torch.core.request import Request
    from repro_torch.kernels import build
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.kernels import bench
    # the kernel modules (the package's names of the same spelling are the
    # functions)
    DA, PF, FA = (importlib.import_module(f"repro_torch.kernels.{m}")
                  for m in ("decode_attention", "prefix_attention",
                            "flash_attention"))
    from repro_torch.data import gen_workload
    from repro_torch.launch import serve
    from repro_torch.models import zoo
    from repro_torch.serving.cluster import ClusterRuntime
    from repro_torch.serving.engine import Engine, EngineConfig
    from repro_torch.serving.speculative import SpeculativeConfig

    full_precision_matmuls()
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    libs = build.build_all()
    print(f"build: {len(libs)} kernel libraries in "
          f"{time.perf_counter() - t0:.1f}s "
          f"(nvcc {', '.join(f'{k} {v:.1f}s' for k, v in build.build_seconds.items())})")

    rows = kernel_phase(torch, PA)
    t0 = time.perf_counter()
    merge_phase(torch, PA, torch.empty(64 << 20, dtype=torch.uint8,
                                       device="cuda"))
    print(f"merge: phase took {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    lib_launches, lib_rows = library_phase(torch, bench, DA, PF, FA)
    print(f"library: phase took {time.perf_counter() - t0:.1f}s")
    launches = serve_phase(torch, PA, serve)
    cfg = configs.get_config("smollm-360m")
    params = zoo.build(cfg).init(
        torch.Generator(device="cuda").manual_seed(0), "cuda")
    for name, phase, extra in (
            ("host tier", host_tier_phase, ()),
            ("speculative", spec_phase, (SpeculativeConfig, gen_workload))):
        t0 = time.perf_counter()
        phase(torch, PA, cfg, params, ClusterRuntime, EngineConfig,
              Request, *extra)
        print(f"{name}: phase took {time.perf_counter() - t0:.1f}s")
    del params
    t0 = time.perf_counter()
    mistral = mistral_phase(torch, DA, PA, configs.get_config("mistral-7b"),
                            zoo, Engine, EngineConfig, Request, gen_workload)
    gc.collect()                    # the engines' split hooks hold cycles
    torch.cuda.empty_cache()        # hand the 14.5 GB of weights back
    print(f"mistral: phase took {time.perf_counter() - t0:.1f}s; "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB still "
          "allocated after it")
    t0 = time.perf_counter()
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    moe_phase(torch, DA, PA, configs, zoo, Engine, EngineConfig, Request,
              gen_workload, flush)
    print(f"moe: phase took {time.perf_counter() - t0:.1f}s; "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB still "
          "allocated after it")
    t0 = time.perf_counter()
    rec_cfgs = rec_configs(configs)
    rec_phase(torch, DA, rec_cfgs, zoo, Engine, EngineConfig, Request,
              gen_workload, flush)
    whisper_phase(torch, DA, configs, zoo, flush)
    mixer_phase(torch, bridge, rec_cfgs)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"recurrent: phase took {time.perf_counter() - t0:.1f}s; "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB still "
          "allocated after it")
    t0 = time.perf_counter()
    train_phase(torch, configs, bridge, zoo)
    print(f"train: phase took {time.perf_counter() - t0:.1f}s; "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB still "
          "allocated after it")
    sharded_train_phase(torch, configs, bridge, zoo)
    print(f"sharded train: {torch.cuda.memory_allocated() / 2 ** 30:.2f} "
          "GiB still allocated after it")
    t0 = time.perf_counter()
    dryrun_phase(torch, configs)
    print(f"dryrun: phase took {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    examples_phase(torch, PA, configs, bridge)
    print(f"examples: phase took {time.perf_counter() - t0:.1f}s; "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB still "
          "allocated after it")
    reference_phase(torch, configs, bridge, zoo, Engine, EngineConfig,
                    Request)
    t0 = time.perf_counter()
    moe_reference_phase(torch, configs, bridge, Engine, EngineConfig,
                        Request)
    print(f"moe: reference phase took {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    rec_reference_phase(torch, configs, bridge, Engine, EngineConfig,
                        Request)
    print(f"recurrent: reference phase took "
          f"{time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    slot = smollm_slot_phase(torch, PA, configs, zoo, Engine, EngineConfig,
                             Request, gen_workload, flush)
    tp_reference_phase(torch, configs, bridge, Engine, EngineConfig, Request)
    hetero_cluster_phase(torch, configs, bridge, ClusterRuntime,
                         EngineConfig, Request)
    print(f"tp: slot, reference and cluster phases took "
          f"{time.perf_counter() - t0:.1f}s")
    profile_phase(torch, PA, serve)
    print("check: bf16 kernel vs plain, largest share of the bound used "
          f"(bound 2^-7 |plain| + 2^-6 rms of the plain row): "
          + ", ".join(f"{k} {u:.4f}" for k, u in BOUND_USE.items()))

    main_row = next(r for r in rows if r["B"] == 8 and r["P"] == 128
                    and r["width"] == "smollm-360m")
    kernels = [{
        "name": "paged_decode_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention.py:58",
        "launches": launches, "max_abs_err": main_row["max_abs_err"],
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"]}]
    # split-K decode: the dense plane's launches in the mistral phase and
    # its served lane count with the most dispatches (the wider on a tie);
    # prefix and flash: the library's launches and full smollm-360m width
    serve_row = max(mistral["served"]["decode"],
                    key=lambda r: (r[1], r[0]))[2]
    lib_launches["decode"] = mistral["dense"]["split_k_decode_launches"]
    for kind, name, src, tpu, r in (
            ("decode", "decode_attention", "decode_attention.cu",
             "src/repro/kernels/decode_attention.py:56", serve_row),
            ("prefix", "prefix_partial", "prefix_attention.cu",
             "src/repro/kernels/prefix_attention.py:74",
             lib_rows["prefix"][0]),
            ("flash", "flash_attention", "flash_attention.cu",
             "src/repro/kernels/flash_attention.py:90",
             lib_rows["flash"][0])):
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": tpu, "launches": lib_launches[kind],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    # the slot shards' partials launch and the merge across shards: the
    # TP phase's launches and its served lane count with the most
    # dispatches (the wider on a tie)
    _, _, prow, mrow = max(slot["served"], key=lambda r: (r[1], r[0]))
    for r, name, src, tpu, n in (
            (prow, "paged_decode_partials", "paged_attention.cu",
             "src/repro/kernels/paged_attention.py:58",
             slot["partials_launches"]),
            (mrow, "lse_merge_partials", "attention.cuh",
             "src/repro/kernels/decode_attention.py:101",
             slot["merge_launches"])):
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": tpu, "launches": n, "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
