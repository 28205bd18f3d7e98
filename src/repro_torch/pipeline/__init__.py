"""repro_torch.pipeline — the bucketed, pipelined execution of collective
schedules.

  * :mod:`repro_torch.pipeline.bucket`   — Bucketer: the block-aligned
                                           partition of the flat exchange
  * :mod:`repro_torch.pipeline.ir`       — PipelinedPlan and the lowering
                                           CommPlan -> per-bucket stages
  * :mod:`repro_torch.pipeline.executor` — the wavefront executor over the
                                           issue/complete halves of each op

``repro_torch.core.comm`` lowers an exchange through this package when
asked for ``n_buckets > 1``.
"""
from repro_torch.pipeline.bucket import Bucketer
from repro_torch.pipeline.executor import Wavefront, execute_pipelined
from repro_torch.pipeline.ir import (BucketPlan, PipelinedPlan,
                                     lower_to_pipelined)

__all__ = ["BucketPlan", "Bucketer", "PipelinedPlan", "Wavefront",
           "execute_pipelined", "lower_to_pipelined"]
