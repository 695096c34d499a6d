"""Serving substrate of the port: paged KV pool, per-instance engine and
cluster runtime."""

from .kv_cache import PagedKVPool, PageTable
from .engine import Engine, EngineConfig
from .cluster import ClusterRuntime

__all__ = ["PagedKVPool", "PageTable", "Engine", "EngineConfig",
           "ClusterRuntime"]
