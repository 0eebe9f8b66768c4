"""Profiling & calibration subsystem (paper §3.2's measurement loop), the
port's copy of ``repro/profile/``.

``runner`` measures (kernels, layers) on the card through the port's
kernels, ``store`` persists the measurements with provenance, ``model``
serves them to the performance predictor behind the CostSource protocol
with per-entry analytic fallback.
"""
from repro_torch.profile.model import CALIB_DEVICE, ProfiledCostModel
from repro_torch.profile.store import PROFILE_DIR, Entry, ProfileStore

__all__ = ["CALIB_DEVICE", "Entry", "PROFILE_DIR", "ProfiledCostModel",
           "ProfileStore"]
