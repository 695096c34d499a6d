"""Pure-decode steps of the paged engine replayed as CUDA graphs.

A decode step of a dense (SwiGLU) paged stack enqueues a few thousand
small kernels (about a hundred a layer); on the card the host's enqueue,
not the device, sets the step's time. ``DecodeGraphs`` captures the
forward of ``api.decode_paged`` once for each lane bucket of the engine
(1, 2, 4, ... up to ``bucket(max_batch_requests)``) and replays it: one
launch from the host in place of thousands. The replayed kernels are
the eager ones, the paged decode kernel included.

What may be captured: a forward that reads nothing back to the host
(``rope``'s frequencies are made on the device, ``models/common.py``),
keeps no allocation past the graph (intermediates live in the graphs'
one memory pool, their inputs in static buffers) and, at capture,
writes only the scratch page 0: the capture inputs are all-scratch
lanes (table rows of page 0, position 0, token 0), the padding lanes of
every step. Each bucket runs once eagerly on the capture stream before
it is captured (kernel builds, cuBLAS workspaces and the caches fill
there), on one stream of the runner's own, every bucket at the engine's
build, largest first; the paged kernel's arrival counters for that
stream are made beforehand at their largest size, so no graph allocates
them.

What invalidates the graphs: they hold the addresses of the KV pool and
of the parameters. The parameters never move after the engine is built;
the pool moves only in ``Engine._init_paged`` (a recovery), which drops
every graph. A recovered engine holds no request, so nothing is
captured there: a bucket is captured again at its first use (``get``),
and a recovery costs no capture time.

Who replays: ``eligible`` reads what the engine is. A tensor-parallel
instance, a speculative engine (every step is a fused one) and routed
MoE positions (``layers._routed`` reads its per-expert counts on the
host, which no graph may hold) stay eager, as does every engine off the
card and every step taken while an ``analysis.counting.Counter`` is
active. Mixed (prefill + decode) steps are always eager.

``paged_decode_attention.launches`` keeps counting one launch a layer:
a replay adds the launches its capture made, and capture itself leaves
the count as it found it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from ..analysis import counting
from ..kernels import paged_attention as PA
from ..models.transformer import layer_plan
from .batch import ModelWorkerBatch, bucket, lower_arrays


def eligible(eng) -> bool:
    """Whether ``eng``'s pure-decode steps replay graphs now: a
    single-card paged engine on CUDA, no draft model, no counter active,
    every layer position's FFN dense (``"mlp"``)."""
    return (eng.paged and eng.device.type == "cuda" and eng.plan is None
            and eng.econf.speculative is None and counting.ACTIVE is None
            and all(p.ffn == "mlp" for p in layer_plan(eng.model_cfg)))


def decode_batch(tokens: np.ndarray, pos: np.ndarray, page_table: np.ndarray
                 ) -> ModelWorkerBatch:
    """The worker batch of a pure-decode step (an empty chunk half)."""
    P = page_table.shape[1]
    return ModelWorkerBatch(np.zeros((0, 1), np.int32),
                            np.zeros(0, np.int32), np.zeros(0, np.int32),
                            np.zeros((0, P), np.int32), tokens, pos,
                            page_table)


@dataclass
class Graph:
    """One bucket's graph: ``inputs`` the flat int32 buffer that a step's
    packed arrays land in (``lower_arrays(..., out=inputs)``), ``out``
    the [Bb] next tokens a replay writes, ``launches`` the paged kernel
    launches it holds."""
    graph: torch.cuda.CUDAGraph
    inputs: torch.Tensor
    out: torch.Tensor
    launches: int


class DecodeGraphs:
    """The decode graphs of one engine (module doc)."""

    def __init__(self, eng):
        self.eng = eng
        self.stream = torch.cuda.Stream(eng.device)
        self.graphs: Dict[int, Graph] = {}
        self.pool = None
        # the paged kernel's arrival counters for the capture stream, at
        # their largest size before any capture
        with torch.cuda.stream(self.stream):
            PA.arrival_counters(eng.device, bucket(
                eng.econf.max_batch_requests) * eng.model_cfg.n_kv_heads)

    def drop(self) -> None:
        """Forget every graph (and free their pool once unreferenced)."""
        self.graphs = {}
        self.pool = None

    def get(self, Bb: int) -> Optional[Graph]:
        """The graph of bucket ``Bb``, captured first where it is missing
        (after a recovery); None while a counter is active."""
        if counting.ACTIVE is not None:
            return None
        graph = self.graphs.get(Bb)
        return graph if graph is not None else self._capture(Bb)

    def _forward(self, tokens, pos, page_table) -> torch.Tensor:
        eng = self.eng
        nxt, _ = eng.api.decode_paged(
            eng.params, eng.pages,
            {"tokens": tokens, "pos": pos, "page_table": page_table})
        return nxt

    def capture(self) -> None:
        """Capture every bucket, largest first (at the engine's build)."""
        Bb = bucket(self.eng.econf.max_batch_requests)
        while Bb >= 1:
            self._capture(Bb)
            Bb //= 2

    def _capture(self, Bb: int) -> Graph:
        """Capture bucket ``Bb`` (module doc); counted in the engine's
        ``decode_graph_captures``."""
        eng = self.eng
        dev = eng.device
        P = eng._pages_per_req
        launches0 = PA.paged_decode_attention.launches
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        cur = torch.cuda.current_stream(dev)
        inputs = torch.empty(Bb * (2 + P), dtype=torch.int32, device=dev)
        views = lower_arrays(decode_batch(
            np.zeros(Bb, np.int32), np.zeros(Bb, np.int32),
            np.zeros((Bb, P), np.int32)).arrays(), dev, out=inputs)
        tokens, pos, table = views[4:]
        self.stream.wait_stream(cur)
        with torch.no_grad():
            with torch.cuda.stream(self.stream):
                self._forward(tokens, pos, table)
            graph = torch.cuda.CUDAGraph()
            n0 = PA.paged_decode_attention.launches
            with torch.cuda.graph(graph, pool=self.pool, stream=self.stream):
                out = self._forward(tokens, pos, table)
        cur.wait_stream(self.stream)
        g = Graph(graph, inputs, out, PA.paged_decode_attention.launches - n0)
        PA.paged_decode_attention.launches = launches0
        self.graphs[Bb] = g
        eng.stats["decode_graph_captures"] += 1
        return g

    @staticmethod
    def replay(g: Graph) -> torch.Tensor:
        """Run ``g`` on the current stream; returns its output tokens,
        valid until the next replay of any of the engine's graphs (they
        share one memory pool)."""
        g.graph.replay()
        PA.paged_decode_attention.launches += g.launches
        return g.out
