"""Continuous-batching serving (port of ``repro/serve``): the engine, the
traffic-drift replanner and the scripted trace."""
from repro_torch.serve.engine import (Completion, DriftReplanner, Request,
                                      ServeEngine, ServeReport,
                                      decode_sequential,
                                      fixed_batch_occupancy)
from repro_torch.serve.trace import scripted_trace

__all__ = [
    "Completion", "DriftReplanner", "Request", "ServeEngine",
    "ServeReport", "decode_sequential", "fixed_batch_occupancy",
    "scripted_trace",
]
