"""Serving substrate of the port: paged KV pool, host KV tier, draft
plane for speculative decoding, per-instance engine and cluster
runtime."""

from .kv_cache import PagedKVPool, PageTable
from .kv_offload import HostKVStore, PagedHostTier
from .speculative import DraftWorker, SpeculativeConfig
from .engine import Engine, EngineConfig
from .cluster import ClusterRuntime

__all__ = ["PagedKVPool", "PageTable", "HostKVStore", "PagedHostTier",
           "DraftWorker", "SpeculativeConfig", "Engine", "EngineConfig",
           "ClusterRuntime"]
