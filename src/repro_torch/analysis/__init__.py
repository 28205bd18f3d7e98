"""repro_torch.analysis — the analytic model of a training step.

  * :mod:`repro_torch.analysis.model_math` — model FLOPs (the 6ND
                                             yardstick), parameter and
                                             activation bytes, backward
                                             ready times
  * :mod:`repro_torch.analysis.scaling`    — predicted step time and
                                             throughput over cluster sizes
  * :mod:`repro_torch.analysis.roofline`   — the roofline terms of one
                                             traced step (the dry run's
                                             counter)
"""
