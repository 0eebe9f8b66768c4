"""Online stage telemetry (the observation half of HETHUB's closed loop;
the port's copy of ``repro/telemetry/``).

``StageTelemetry`` records per-tick times of the one-process pipeline
loss; ``RankTelemetry`` records each rank's schedule ops on the rank
route (``OpClock``).  The Trainer folds both into its online profile as
``observed_stage_tick`` / ``observed_bubble`` entries, which the replan
consumes.
"""
from repro_torch.telemetry.recorder import (  # noqa: F401
    MODES, OpClock, RankTelemetry, StageTelemetry)
