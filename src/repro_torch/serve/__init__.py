"""Continuous-batching serving (port of ``repro/serve``)."""
from repro_torch.serve.engine import (Completion, Request, ServeEngine,
                                      ServeReport, decode_sequential,
                                      fixed_batch_occupancy)
from repro_torch.serve.trace import scripted_trace

__all__ = [
    "Completion", "Request", "ServeEngine", "ServeReport",
    "decode_sequential", "fixed_batch_occupancy", "scripted_trace",
]
