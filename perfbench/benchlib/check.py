"""How ``correct`` is decided: the served tokens of a sample of the
window's requests against the configuration's plain reference.

The sample is drawn from the run's seed among the window's finished
requests, the longest of them always in it, until it holds at least
``sample_tokens`` served tokens. The reference runs once over each
prompt followed by its served tokens (all but the last) and gives the
float32 logits at every position that produced a served token. A served
token's gap is the reference's best logit there minus the reference's
logit of the served token: 0 where the program picked what the reference
picks, and small where rounding tipped a near tie.

The compared numbers (each with its limit in the configuration's
``"check"``): ``gap_max``, the widest gap of the sample, and
``gap_mean``, the mean gap over its served tokens.

``control_gaps`` reads the same numbers for the control: the reference
computed in fp8 put in the program's place, its own first choice at
every position of the same prompts and served tokens.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

# sequences handed to the reference at once, by their summed tokens
REF_BLOCK_TOKENS = 16384


def draw_sample(reqs: Sequence[Any], seed: int, sample_tokens: int
                ) -> List[Any]:
    """The longest request first, then others in an order drawn from
    ``seed`` until ``sample_tokens`` served tokens are in."""
    if not reqs:
        return []
    longest = max(range(len(reqs)), key=lambda i: (
        reqs[i].prompt_len + len(reqs[i].output_tokens), -i))
    rest = [i for i in range(len(reqs)) if i != longest]
    order = np.random.default_rng([seed, 3]).permutation(len(rest))
    out, total = [reqs[longest]], len(reqs[longest].output_tokens)
    for j in order:
        if total >= sample_tokens:
            break
        out.append(reqs[rest[j]])
        total += len(reqs[rest[j]].output_tokens)
    return out


def _sequences(sample) -> List[Tuple[List[int], List[int]]]:
    seqs = []
    for r in sample:
        out = list(r.output_tokens)
        P = r.prompt_len
        seqs.append((list(r.tokens) + out[:-1],
                     list(range(P - 1, P - 1 + len(out)))))
    return seqs


def _blocks(items: List[Any], size) -> List[List[int]]:
    blocks, cur, n = [], [], 0
    for i, it in enumerate(items):
        if cur and n + size(it) > REF_BLOCK_TOKENS:
            blocks.append(cur)
            cur, n = [], 0
        cur.append(i)
        n += size(it)
    if cur:
        blocks.append(cur)
    return blocks


def reference_logits(reference, params, cfg, sample, precision: str
                     ) -> List[torch.Tensor]:
    seqs = _sequences(sample)
    out: List[torch.Tensor] = [None] * len(seqs)
    for block in _blocks(seqs, lambda s: len(s[0])):
        got = reference.logits(params, cfg, [seqs[i] for i in block],
                               precision)
        for i, g in zip(block, got):
            out[i] = g
    return out


def _numbers(gaps: List[torch.Tensor]) -> Dict[str, float]:
    g = torch.cat(gaps).double()
    return {"gap_max": float(g.max()), "gap_mean": float(g.mean()),
            "tokens": int(g.numel())}


def served_gaps(sample, ref_logits) -> Dict[str, float]:
    gaps = []
    for r, L in zip(sample, ref_logits):
        t = torch.tensor(r.output_tokens, device=L.device)
        gaps.append(L.max(-1).values - L[torch.arange(len(t)), t])
    return _numbers(gaps)


def control_gaps(ref_logits, ctl_logits) -> Dict[str, float]:
    gaps = []
    for L, C in zip(ref_logits, ctl_logits):
        t = C.argmax(-1)
        gaps.append(L.max(-1).values - L[torch.arange(len(t)), t])
    return _numbers(gaps)


def judge(numbers: Dict[str, float], limits: Dict[str, float],
          failed: int) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """(correct, each compared number beside its limit); ``failed``: the
    window's requests that never finished or were refused."""
    compared = {k: {"value": numbers[k], "limit": v}
                for k, v in limits.items()}
    compared["failed_requests"] = {"value": failed, "limit": 0}
    ok = all(c["value"] <= c["limit"] for c in compared.values())
    return ok, compared
