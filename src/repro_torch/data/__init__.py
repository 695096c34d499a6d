from .workloads import (WORKLOADS, WorkloadStats, gen_workload,
                        workload_stats)
from .arrivals import (poisson_arrivals, azure_burst_arrivals,
                       assign_arrivals, zipf_choice)

__all__ = ["WORKLOADS", "WorkloadStats", "gen_workload", "workload_stats",
           "poisson_arrivals", "azure_burst_arrivals", "assign_arrivals",
           "zipf_choice"]
