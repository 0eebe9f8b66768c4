"""Versioned profile database (paper §3.2 'sampling' persisted); a copy
of ``repro/profile/store.py`` for the port, schema v1 and the same JSON,
so a profile written by either package loads in the other.

One JSON file per device kind under ``chiprun_out/profiles/`` (gitignored).
Entries are keyed by (device_kind, op, shape): ``shape`` is a flat dict of
axis name -> value (ints/floats are interpolation axes, strings are exact
selectors).  Every entry carries provenance metadata (who measured it, with
what torch/backend, when) so stale profiles are auditable rather than silent.

The store supports three access patterns:
  * exact ``get`` — the runner and tests;
  * ``fold`` — online refinement: running-mean update of a measured value
    (Trainer folds observed step wall-times back in);
  * ``interpolate`` — multilinear interpolation over the numeric shape axes
    (the ProfiledCostModel's read path).  Returns None when the requested
    point cannot be bracketed, so callers can fall back per-entry to the
    analytic model.
"""
from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch

SCHEMA_VERSION = 1

# Fields with a NEUTRAL per-observation default: when a fold or merge
# brings such a field to an entry whose history predates it (a store
# persisted before the field existed), the missing history counts at this
# value instead of inheriting the incoming one — the new observation must
# not retroactively re-tag the old ones.  ``obs_scale``: untagged
# observations are reference-healthy (1.0), which is also exactly how
# readers interpret its absence.
NEUTRAL_FIELDS = {"obs_scale": 1.0}

PROFILE_DIR = (Path(__file__).resolve().parents[3]
               / "chiprun_out" / "profiles")


def _key(device_kind: str, op: str, shape: Dict[str, Any]) -> str:
    parts = [device_kind, op] + [f"{k}={shape[k]}" for k in sorted(shape)]
    return "|".join(parts)


@dataclasses.dataclass
class Entry:
    device_kind: str
    op: str
    shape: Dict[str, Any]
    value: Dict[str, float]
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        return {"device_kind": self.device_kind, "op": self.op,
                "shape": self.shape, "value": self.value, "meta": self.meta}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Entry":
        return cls(device_kind=d["device_kind"], op=d["op"],
                   shape=dict(d["shape"]), value=dict(d["value"]),
                   meta=dict(d.get("meta", {})))


def default_meta() -> Dict[str, Any]:
    """Provenance stamped onto new measurements."""
    backend = "cuda" if torch.cuda.is_available() else "cpu"
    return {"timestamp": time.time(), "torch": torch.__version__,
            "backend": backend, "schema": SCHEMA_VERSION}


class ProfileStore:
    def __init__(self, path: Optional[Path] = None):
        self.path = Path(path) if path else None
        self._entries: Dict[str, Entry] = {}
        self.meta: Dict[str, Any] = {"version": SCHEMA_VERSION,
                                     "created": time.time()}

    # ------------------------------------------------------------- io -----
    @classmethod
    def load(cls, path) -> "ProfileStore":
        path = Path(path)
        st = cls(path)
        doc = json.loads(path.read_text())
        if doc.get("version", 0) > SCHEMA_VERSION:
            raise ValueError(f"profile {path} written by newer schema "
                             f"v{doc['version']} (reader is v{SCHEMA_VERSION})")
        st.meta = {k: v for k, v in doc.items() if k != "entries"}
        for d in doc.get("entries", []):
            e = Entry.from_dict(d)
            st._entries[_key(e.device_kind, e.op, e.shape)] = e
        return st

    @classmethod
    def open(cls, path) -> "ProfileStore":
        """Load if the file exists, else a fresh store bound to the path."""
        path = Path(path)
        return cls.load(path) if path.exists() else cls(path)

    @classmethod
    def for_device(cls, device_kind: str, root: Optional[Path] = None
                   ) -> "ProfileStore":
        root = Path(root) if root else PROFILE_DIR
        safe = "".join(c if (c.isalnum() or c in "-_.") else "_"
                       for c in device_kind)
        return cls.open(root / f"{safe}.json")

    def save(self, path=None) -> Path:
        path = Path(path) if path else self.path
        if path is None:
            raise ValueError("ProfileStore has no path bound; pass one")
        path.parent.mkdir(parents=True, exist_ok=True)
        doc = dict(self.meta)
        doc["version"] = SCHEMA_VERSION
        doc["updated"] = time.time()
        doc["entries"] = [e.to_dict() for e in self._entries.values()]
        tmp = path.with_suffix(".tmp")
        tmp.write_text(json.dumps(doc, indent=1, sort_keys=True))
        tmp.replace(path)   # atomic: a reader never sees a torn profile
        self.path = path
        return path

    # ---------------------------------------------------------- write -----
    def put(self, device_kind: str, op: str, shape: Dict[str, Any],
            value: Dict[str, float],
            meta: Optional[Dict[str, Any]] = None) -> Entry:
        e = Entry(device_kind, op, dict(shape), dict(value),
                  meta if meta is not None else default_meta())
        self._entries[_key(device_kind, op, e.shape)] = e
        return e

    def fold(self, device_kind: str, op: str, shape: Dict[str, Any],
             field: str, measured: float, weight: float = 1.0,
             also: Optional[Dict[str, float]] = None) -> Entry:
        """Online refinement: fold one observation into the stored value as
        a weighted running mean (value keeps an ``n`` observation count).
        ``also`` folds extra fields belonging to the SAME observation —
        one ``n`` bump covers the whole record, so paired fields (e.g. a
        tick time and the ``obs_scale`` health it was measured under) stay
        aligned under folding and ``merge``.  A field missing from the
        existing entry back-fills its prior history at its
        ``NEUTRAL_FIELDS`` default when it has one (else at the incoming
        value), so folding into a pre-field legacy entry never re-tags
        the old observations."""
        fields = {field: measured, **(also or {})}
        e = self.get(device_kind, op, shape)
        if e is None:
            return self.put(device_kind, op, shape,
                            {**fields, "n": weight})
        n = e.value.get("n", 1.0)
        # both directions: a neutral field the entry carries but the
        # incoming observation omits folds at neutral too (the incoming
        # observation must not inherit the entry's scale)
        for f, neutral in NEUTRAL_FIELDS.items():
            if f in e.value and f not in fields:
                fields[f] = neutral
        for f, v in fields.items():
            prev = e.value.get(f)
            if prev is None:
                prev = NEUTRAL_FIELDS.get(f, v)
            e.value[f] = (prev * n + v * weight) / (n + weight)
        e.value["n"] = n + weight
        e.meta.update(default_meta())
        return e

    def merge(self, other: "ProfileStore",
              ops: Optional[List[str]] = None) -> int:
        """Fold-merge every entry of ``other`` into this store (multi-host
        telemetry aggregation: each process folds observations into its own
        local store; merging the remote stores yields the same running
        means as if every observation had been folded into one store,
        because n-weighted means compose exactly).

        ``ops`` restricts the merge to those entry kinds (None = all).
        Entries missing an ``n`` count are treated as single observations.
        When the same key carries different ``provenance`` metadata on the
        two sides, the merged entry keeps the LESS trusted one
        (``bucketed`` over ``exact``) so a mixed fold is never over-trusted.
        Returns the number of entries merged in."""
        merged = 0
        for e in other.entries():
            if ops is not None and e.op not in ops:
                continue
            mine = self.get(e.device_kind, e.op, e.shape)
            if mine is None:
                self.put(e.device_kind, e.op, e.shape, dict(e.value),
                         meta=dict(e.meta))
                merged += 1
                continue
            na = mine.value.get("n", 1.0)
            nb = e.value.get("n", 1.0)
            # neutral back-fill runs BOTH ways — whichever side's history
            # predates the field counts at neutral, so the merge stays
            # order-independent and never re-tags old observations
            incoming = dict(e.value)
            for f, neutral in NEUTRAL_FIELDS.items():
                if f in mine.value and f not in incoming:
                    incoming[f] = neutral
            for f, v in incoming.items():
                if f == "n":
                    continue
                mv = mine.value.get(f)
                if mv is None:
                    mv = NEUTRAL_FIELDS.get(f)
                    if mv is None:
                        mine.value[f] = v
                        continue
                mine.value[f] = (mv * na + v * nb) / (na + nb)
            if "n" in mine.value or "n" in e.value:
                mine.value["n"] = na + nb
            if e.meta.get("provenance") == "bucketed":
                mine.meta["provenance"] = "bucketed"
            merged += 1
        return merged

    # --------------------------------- membership / bounded staleness -----
    # A departed device kind's entries are NOT dropped immediately: a
    # flapping node that rejoins within ``keep_steps`` gets its warm
    # profile back (no re-baseline, no planner thrash).  Past the bound
    # the kind's entries are stale — ``drop_device`` removes them from
    # planning for good.  The marks live in ``meta`` so they persist
    # through save/load with the entries they govern.

    def mark_departed(self, device_kind: str, step: int) -> None:
        """Record that ``device_kind`` left the cluster at ``step`` (its
        entries enter the bounded-staleness window).  Re-marking an
        already-departed kind keeps the ORIGINAL departure step: a flap
        must not keep resetting its own staleness clock."""
        self.meta.setdefault("departed", {}).setdefault(
            device_kind, int(step))

    def mark_rejoined(self, device_kind: str) -> bool:
        """Clear a departure mark (the kind is back; its kept entries
        serve again).  Returns whether a mark existed."""
        return self.meta.get("departed", {}).pop(device_kind, None) \
            is not None

    def departed_since(self, device_kind: str) -> Optional[int]:
        """The step ``device_kind`` departed at, or None if present."""
        v = self.meta.get("departed", {}).get(device_kind)
        return int(v) if v is not None else None

    def stale_kinds(self, now_step: int, keep_steps: int) -> List[str]:
        """Departed kinds whose staleness bound has passed (departed more
        than ``keep_steps`` steps ago) — due for ``drop_device``."""
        return sorted(k for k, s in self.meta.get("departed", {}).items()
                      if now_step - int(s) > keep_steps)

    def drop_device(self, device_kind: str) -> int:
        """Remove every entry of ``device_kind`` (and its departure
        mark): the bounded-staleness expiry.  Returns how many entries
        were dropped."""
        doomed = [k for k, e in self._entries.items()
                  if e.device_kind == device_kind]
        for k in doomed:
            del self._entries[k]
        self.meta.get("departed", {}).pop(device_kind, None)
        return len(doomed)

    # ----------------------------------------------------------- read -----
    def get(self, device_kind: str, op: str,
            shape: Dict[str, Any]) -> Optional[Entry]:
        return self._entries.get(_key(device_kind, op, shape))

    def entries(self, device_kind: Optional[str] = None,
                op: Optional[str] = None) -> List[Entry]:
        return [e for e in self._entries.values()
                if (device_kind is None or e.device_kind == device_kind)
                and (op is None or e.op == op)]

    def __len__(self) -> int:
        return len(self._entries)

    def interpolate(self, device_kind: str, op: str, shape: Dict[str, Any],
                    field: str) -> Optional[float]:
        """Multilinear interpolation of ``value[field]`` at ``shape``.

        String-valued shape axes select exactly; numeric axes interpolate.
        Grid points outside the measured range clamp to the boundary (a
        profile should not be silently extrapolated past its sweep).
        Returns None if no matching entries exist or the surrounding grid
        is incomplete — the caller falls back to its analytic model.
        """
        fixed = {k: v for k, v in shape.items() if isinstance(v, str)}
        numeric = {k: float(v) for k, v in shape.items()
                   if not isinstance(v, str)}
        cands = [e for e in self.entries(device_kind, op)
                 if all(e.shape.get(k) == v for k, v in fixed.items())
                 and set(k for k, v in e.shape.items()
                         if not isinstance(v, str)) == set(numeric)
                 and field in e.value]
        if not cands:
            return None
        axes = sorted(numeric)
        return _multilinear(cands, axes, numeric, field)


def main(argv: Optional[List[str]] = None) -> int:
    """Inspector CLI: tabular dump of a profile store.

        python -m repro_torch.profile.store PATH [--kind OP] [--device KIND]

    One row per entry — device kind, op, shape, observation count ``n``,
    the value fields, provenance and ``obs_scale`` — replacing the old
    debugging path of reading the raw JSON by hand."""
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.profile.store",
        description="Tabular dump of a profile-store JSON file.")
    ap.add_argument("path", help="profile store JSON file")
    ap.add_argument("--kind", default=None,
                    help="restrict to one entry kind/op "
                         "(e.g. observed_stage_tick)")
    ap.add_argument("--device", default=None,
                    help="restrict to one device kind (e.g. gpu-a)")
    args = ap.parse_args(argv)
    try:
        store = ProfileStore.load(args.path)
    except (OSError, ValueError) as e:
        ap.error(f"cannot read profile store {args.path!r}: {e}")
    entries = store.entries(device_kind=args.device, op=args.kind)
    entries.sort(key=lambda e: (e.device_kind, e.op,
                                json.dumps(e.shape, sort_keys=True)))
    print(f"{args.path}: {len(entries)}/{len(store)} entries "
          f"(schema v{store.meta.get('version', '?')})")
    hdr = (f"{'device':<12} {'op':<22} {'n':>7} {'value':<26} "
           f"{'prov':<9} {'obs_scale':>9}  shape")
    print(hdr)
    print("-" * len(hdr))
    for e in entries:
        n = e.value.get("n", 1.0)
        fields = " ".join(f"{k}={v:.6g}" for k, v in sorted(e.value.items())
                          if k not in ("n", "obs_scale"))
        prov = e.meta.get("provenance", "-")
        scale = e.value.get("obs_scale")
        shape = " ".join(f"{k}={e.shape[k]}" for k in sorted(e.shape))
        print(f"{e.device_kind:<12} {e.op:<22} {n:>7.1f} {fields:<26} "
              f"{prov:<9} "
              f"{scale:>9.4f}  {shape}" if scale is not None else
              f"{e.device_kind:<12} {e.op:<22} {n:>7.1f} {fields:<26} "
              f"{prov:<9} {'-':>9}  {shape}")
    return 0


def _multilinear(cands: List[Entry], axes: List[str],
                 point: Dict[str, float], field: str) -> Optional[float]:
    if not axes:
        return float(cands[0].value[field]) if cands else None
    ax, rest = axes[0], axes[1:]
    x = point[ax]
    grid = sorted({float(e.shape[ax]) for e in cands})
    if x <= grid[0]:
        lo = hi = grid[0]
    elif x >= grid[-1]:
        lo = hi = grid[-1]
    else:
        import bisect
        i = bisect.bisect_left(grid, x)
        if grid[i] == x:
            lo = hi = x
        else:
            lo, hi = grid[i - 1], grid[i]
    v_lo = _multilinear([e for e in cands if float(e.shape[ax]) == lo],
                        rest, point, field)
    if lo == hi:
        return v_lo
    v_hi = _multilinear([e for e in cands if float(e.shape[ax]) == hi],
                        rest, point, field)
    if v_lo is None or v_hi is None:
        return None
    w = (x - lo) / (hi - lo)
    return v_lo * (1.0 - w) + v_hi * w


if __name__ == "__main__":
    raise SystemExit(main())
