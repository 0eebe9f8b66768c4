"""Run identity: the shared header every exported observability artifact
carries.

Multi-run artifact directories were unattributable: a trace, a metrics
stream, an AdaptEvent log and a flight-recorder dump written by different
runs (or different plans of one run) looked identical.  ``RunMeta`` fixes
that: one ``run_id`` minted at launch plus the digest of the plan the run
started under, stamped into every artifact header — the report CLI
refuses to correlate artifacts whose run ids disagree.

``plan_digest`` is a content hash of ``ParallelPlan.to_dict()`` (the same
canonical form the adaptation controller broadcasts), so two plans are
attributably identical iff they would execute identically.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import time
import uuid
from typing import Any, Dict, Optional

SCHEMA_VERSION = 1


def plan_digest(plan) -> str:
    """Stable content digest of a ParallelPlan (12 hex chars of sha256
    over the sorted-key JSON of ``to_dict()``)."""
    doc = json.dumps(plan.to_dict(), sort_keys=True)
    return hashlib.sha256(doc.encode()).hexdigest()[:12]


def new_run_id() -> str:
    """Sortable-by-launch-time unique run id."""
    return (time.strftime("%Y%m%d-%H%M%S", time.gmtime())
            + "-" + uuid.uuid4().hex[:8])


@dataclasses.dataclass(frozen=True)
class RunMeta:
    """The identity header shared by every artifact of one run."""
    run_id: str
    plan_digest: Optional[str] = None   # digest of the LAUNCH plan
    arch: Optional[str] = None
    created_unix: float = 0.0

    @classmethod
    def new(cls, plan=None, arch: Optional[str] = None) -> "RunMeta":
        return cls(run_id=new_run_id(),
                   plan_digest=plan_digest(plan) if plan is not None
                   else None,
                   arch=arch, created_unix=time.time())

    def to_dict(self) -> Dict[str, Any]:
        return {"run_id": self.run_id, "plan_digest": self.plan_digest,
                "arch": self.arch, "created_unix": self.created_unix,
                "schema": SCHEMA_VERSION}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "RunMeta":
        return cls(run_id=d["run_id"], plan_digest=d.get("plan_digest"),
                   arch=d.get("arch"),
                   created_unix=d.get("created_unix", 0.0))
