"""Flight recorder: a bounded ring of recent structured events, dumped on
failure.

The adaptation loop fails in ways a stack trace alone can't explain — a
``ScheduleError`` out of the planner, a live-migration fallback, a
SIGTERM from the cluster scheduler mid-replan.  What the post-mortem
needs is the last few hundred things the controller *saw and decided*:
ticks, profile folds, policy evaluations, directives, migrations.  The
recorder keeps exactly that in a fixed-size deque (O(1) per note, no
I/O) and serialises it only when something goes wrong.

Dump triggers (wired by trainer / train CLI):

  * ``ScheduleError`` escaping ``Trainer.run``;
  * live-migration failure (the checkpoint-fallback path in
    ``Trainer._adopt``);
  * SIGTERM via ``install_sigterm`` (dump, then chain the previous
    handler so the process still terminates).

The dump carries the run-identity header and is uploaded with the
replan-e2e failure artifact in CI.
"""
from __future__ import annotations

import collections
import json
import signal
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

from repro_torch.obs.runmeta import RunMeta

DEFAULT_CAPACITY = 512


class FlightRecorder:
    """Bounded ring of ``{"ts", "kind", "step", ...detail}`` events."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 run: Optional[RunMeta] = None):
        self.run = run or RunMeta.new()
        self.ring: collections.deque = collections.deque(maxlen=capacity)
        self.dumped: List[str] = []   # reasons already dumped (dedup)

    def note(self, kind: str, step: Optional[int] = None,
             **detail: Any) -> None:
        rec = {"ts": time.time(), "kind": kind}
        if step is not None:
            rec["step"] = step
        if detail:
            rec.update(detail)
        self.ring.append(rec)

    def __len__(self) -> int:
        return len(self.ring)

    def to_dict(self, reason: str) -> Dict[str, Any]:
        return {"kind": "flight", "schema": 1, "reason": reason,
                "dumped_unix": time.time(), "run": self.run.to_dict(),
                "events": list(self.ring)}

    def dump(self, path, reason: str) -> Path:
        """Write the ring to ``path``; repeat dumps get numbered suffixes
        so a SIGTERM after a migration failure keeps both snapshots."""
        path = Path(path)
        if self.dumped:
            path = path.with_name(
                f"{path.stem}.{len(self.dumped)}{path.suffix}")
        self.dumped.append(reason)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(self.to_dict(reason)))
        return path


# the (recorder, path, handler, prev) this module last installed — the
# idempotence/uninstall bookkeeping below.  One slot suffices: a process
# has one SIGTERM handler, so there is never more than one live install.
_installed: Optional[tuple] = None


def install_sigterm(recorder: FlightRecorder, path) -> None:
    """Dump the ring on SIGTERM, then chain the previous handler (or
    re-raise the default termination) — the process still dies, but the
    last ~recorder.capacity decisions survive it.

    IDEMPOTENT per (recorder, path): re-installing the same pair is a
    no-op, and installing a different pair REPLACES this module's handler
    (chaining to whatever preceded it) instead of chaining onto it —
    repeated Trainer runs in one process must not build an unbounded
    handler chain that double-dumps on every signal.  Handlers installed
    by OTHER code after ours are still chained normally.  Use
    ``uninstall_sigterm`` for test teardown."""
    global _installed
    path = Path(path)
    current = signal.getsignal(signal.SIGTERM)
    if _installed is not None and current is _installed[2]:
        if _installed[0] is recorder and _installed[1] == path:
            return                    # same (recorder, path): no-op
        prev = _installed[3]          # replace our handler, keep ITS prev
    else:
        prev = current                # foreign handler: chain it

    def _handler(signum, frame):
        try:
            recorder.dump(path, reason="sigterm")
        finally:
            if callable(prev):
                prev(signum, frame)
            else:
                signal.signal(signal.SIGTERM, signal.SIG_DFL)
                signal.raise_signal(signal.SIGTERM)

    signal.signal(signal.SIGTERM, _handler)
    _installed = (recorder, path, _handler, prev)


def uninstall_sigterm() -> bool:
    """Remove this module's SIGTERM handler, restoring whatever it had
    chained (test teardown).  Returns True when a handler was removed;
    False when none was installed — or when other code has since replaced
    it (then it is THEIR chain to manage, and we only drop our
    bookkeeping)."""
    global _installed
    if _installed is None:
        return False
    removed = False
    if signal.getsignal(signal.SIGTERM) is _installed[2]:
        signal.signal(signal.SIGTERM, _installed[3])
        removed = True
    _installed = None
    return removed
