"""Autonomous adaptation controller (the closed HETHUB loop; port of
``repro/adapt``).

``policy`` decides WHEN to adapt — a telemetry-driven replan policy with
hysteresis bands, patience, cooldown and a min-expected-gain gate;
``aggregate`` makes the decision cluster-wide — telemetry fan-in over the
ranks so the policy (and the replan search) see one per-island profile,
not a 1/N per-process view.  The Trainer consults the policy every
telemetry step and invokes ``degrade``/``replan``/migrate itself,
emitting a structured ``AdaptEvent`` log (docs/adaptation.md is the
operator runbook).
"""
from repro_torch.adapt.aggregate import (OBSERVED_OPS, ElectingFanIn,
                                         InMemoryFanIn, LocalAggregator,
                                         MembershipView,
                                         ProcessAllGatherAggregator,
                                         default_aggregator, merge_stores)
from repro_torch.adapt.policy import (AdaptConfig, AdaptDecision, AdaptEvent,
                                      ReplanPolicy, events_json)

__all__ = ["AdaptConfig", "AdaptDecision", "AdaptEvent", "ElectingFanIn",
           "InMemoryFanIn", "LocalAggregator", "MembershipView",
           "OBSERVED_OPS", "ProcessAllGatherAggregator",
           "ReplanPolicy", "default_aggregator", "events_json",
           "merge_stores"]
