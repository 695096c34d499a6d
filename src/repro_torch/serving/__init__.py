"""Serving substrate of the port: paged KV pool, host KV tier, draft
plane for speculative decoding, per-instance engine, cluster runtime and
the discrete-event cluster simulator."""

from .kv_cache import PagedKVPool, PageTable
from .kv_offload import HostKVStore, PagedHostTier
from .speculative import DraftWorker, SpeculativeConfig
from .engine import Engine, EngineConfig
from .cluster import ClusterRuntime
from .simulator import SimConfig, Simulator, simulate

__all__ = ["PagedKVPool", "PageTable", "HostKVStore", "PagedHostTier",
           "DraftWorker", "SpeculativeConfig", "Engine", "EngineConfig",
           "ClusterRuntime", "SimConfig", "Simulator", "simulate"]
