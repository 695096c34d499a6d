# The paper's primary contribution: E2 distributed prompt scheduling
# (global request-level + local iteration-level schedulers over a token
# radix forest with window-H load accounting).

from .radix_tree import (RadixTree, RadixNode, MatchResult, PathKey,
                         PrefixSpan, path_key_of, NOTIFY_PROTOCOL_VERSION)
from .cost_model import CostModel, HardwareSpec, ModelSpec, cost_model_for
from .request import Request, RequestState
from .e2 import (InstanceState, MigrationPlan, ScheduleDecision, e2_schedule,
                 load_cost, plan_migration, subtree_load)
from .global_scheduler import GlobalScheduler, GlobalSchedulerConfig, PodRouter
from .local_scheduler import (AccountingHostTier, Batch, BatchItem,
                              LocalScheduler, LocalSchedulerConfig)

__all__ = [
    "AccountingHostTier",
    "RadixTree", "RadixNode", "MatchResult",
    "PathKey", "PrefixSpan", "path_key_of", "NOTIFY_PROTOCOL_VERSION",
    "CostModel", "HardwareSpec", "ModelSpec", "cost_model_for",
    "Request", "RequestState",
    "InstanceState", "MigrationPlan", "ScheduleDecision", "e2_schedule",
    "load_cost", "plan_migration", "subtree_load",
    "GlobalScheduler", "GlobalSchedulerConfig", "PodRouter",
    "Batch", "BatchItem", "LocalScheduler", "LocalSchedulerConfig",
]
