"""repro_torch.plan — the collective-schedule IR, its builders, the
torch.distributed executor, the α-β cost model and the cluster tuner.

  * :mod:`repro_torch.plan.ir`        — CommPlan + typed collective ops
  * :mod:`repro_torch.plan.schedules` — flat / hierarchical / all-reduce
  * :mod:`repro_torch.plan.executor`  — a plan on torch.distributed
  * :mod:`repro_torch.plan.cost`      — ClusterSpec + α-β pricing
  * :mod:`repro_torch.plan.tune`      — the cheapest valid schedule

The cost model prices the same plan objects the executor runs, and
``repro_torch.benchmarks.comm_volume --check-plans`` holds their byte
counts to the bytes the collectives are handed.
"""
from repro_torch.plan.cost import (CLUSTERS, ClusterSpec, LinkSpec,
                                   bucket_staging_bytes, cross_pod_bytes,
                                   get_cluster, list_clusters, op_compute,
                                   op_time, pipeline_breakdown,
                                   pipelined_plan_time, plan_compute,
                                   plan_compute_time, plan_time,
                                   predict_step_time, wire_watermark)
from repro_torch.plan.executor import execute_plan
from repro_torch.plan.ir import (AllGather, AllReduce, AllToAll, Broadcast,
                                 CollectiveOp, CommPlan, ReduceScatter,
                                 WireSpec)
from repro_torch.plan.schedules import (allreduce_schedule, flat_schedule,
                                        hier_schedule, needs_outer_ef)
from repro_torch.plan.tune import (Candidate, TuneResult, autotune,
                                   build_candidate, enumerate_candidates)

__all__ = [
    "AllGather", "AllReduce", "AllToAll", "Broadcast", "CLUSTERS",
    "Candidate", "ClusterSpec", "CollectiveOp", "CommPlan", "LinkSpec",
    "ReduceScatter", "TuneResult", "WireSpec", "allreduce_schedule",
    "autotune", "bucket_staging_bytes", "build_candidate",
    "cross_pod_bytes", "enumerate_candidates",
    "execute_plan", "flat_schedule", "get_cluster", "hier_schedule",
    "list_clusters", "needs_outer_ef", "op_compute", "op_time",
    "pipeline_breakdown", "pipelined_plan_time", "plan_compute",
    "plan_compute_time", "plan_time", "predict_step_time",
    "wire_watermark",
]
