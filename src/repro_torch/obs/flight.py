"""SLO-breach flight recorder: a ring buffer of per-slice fleet state.

The fleet loop calls :meth:`FlightRecorder.record` once per slice with a
frame of per-engine state (queue depth, placement vector, LUT-cache
counters, admission decisions) and :meth:`FlightRecorder.check` with the
*running* SLO signals (deadline-miss rate, p99 latency). When a signal
crosses its threshold the recorder dumps the last ``capacity`` frames -
the post-mortem window leading up to the breach - as JSON, once per
breach episode (it re-arms only after the signal recovers below the
threshold, so a persistently-missing fleet produces one dump, not one
per slice).

The recorder is passive storage: it never reaches into schedulers or
routers itself, so what a frame contains is decided by the caller
(``repro_torch.fleet.router.Fleet.run`` builds the canonical frame; see
DESIGN.md SS.8 for the schema).
"""
from __future__ import annotations

import collections
import json
from pathlib import Path
from typing import Any, Dict, List, Optional


class FlightRecorder:
    """Ring buffer of the last ``capacity`` slice frames + SLO triggers.

    ``miss_rate_threshold``/``p99_ms_threshold``: ``None`` disables that
    trigger. ``path=None`` keeps dumps in memory (``last_dump``), which
    is what tests use.
    """

    def __init__(self, capacity: int = 64, *,
                 miss_rate_threshold: Optional[float] = 0.5,
                 p99_ms_threshold: Optional[float] = None,
                 path=None) -> None:
        if capacity < 1:
            raise ValueError("flight recorder capacity must be >= 1")
        self.capacity = capacity
        self.miss_rate_threshold = miss_rate_threshold
        self.p99_ms_threshold = p99_ms_threshold
        self.path = Path(path) if path is not None else None
        self.frames: collections.deque = collections.deque(maxlen=capacity)
        self.n_dumps = 0
        self.last_dump: Optional[Dict[str, Any]] = None
        self._armed = True

    # -- per-slice protocol --------------------------------------------------
    def record(self, slice_idx: int, frame: Dict[str, Any]) -> None:
        """Append one slice frame (oldest rotates out past capacity)."""
        self.frames.append({"slice": slice_idx, **frame})

    def check(self, *, deadline_miss_rate: Optional[float] = None,
              p99_ms: Optional[float] = None,
              context: Optional[Dict[str, Any]] = None) -> Optional[Path]:
        """Evaluate the triggers; dump and return the path on a breach.

        Returns ``None`` when nothing fired (or the dump stayed
        in-memory because no ``path`` is set).
        """
        reasons = []
        if (self.miss_rate_threshold is not None
                and deadline_miss_rate is not None
                and deadline_miss_rate >= self.miss_rate_threshold):
            reasons.append(f"deadline_miss_rate {deadline_miss_rate:.3f} "
                           f">= {self.miss_rate_threshold:.3f}")
        if (self.p99_ms_threshold is not None and p99_ms is not None
                and p99_ms >= self.p99_ms_threshold):
            reasons.append(f"p99_ms {p99_ms:.3f} "
                           f">= {self.p99_ms_threshold:.3f}")
        if not reasons:
            self._armed = True          # recovered: re-arm for next breach
            return None
        if not self._armed:
            return None                 # still inside the same episode
        self._armed = False
        return self.dump("; ".join(reasons), context=context,
                         signals={"deadline_miss_rate": deadline_miss_rate,
                                  "p99_ms": p99_ms})

    # -- dumping ------------------------------------------------------------
    def dump(self, reason: str, *, context: Optional[Dict] = None,
             signals: Optional[Dict] = None) -> Optional[Path]:
        """Serialize the ring to JSON (post-mortem window)."""
        self.n_dumps += 1
        payload = {
            "reason": reason,
            "signals": signals or {},
            "context": context or {},
            "capacity": self.capacity,
            "n_frames": len(self.frames),
            "frames": list(self.frames),
        }
        self.last_dump = payload
        if self.path is None:
            return None
        # one file per dump so a second breach never clobbers the first
        out = self.path if self.n_dumps == 1 else self.path.with_name(
            f"{self.path.stem}.{self.n_dumps}{self.path.suffix}")
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(payload, indent=2, default=str))
        return out

    # -- introspection -------------------------------------------------------
    def __len__(self) -> int:
        return len(self.frames)

    def slices(self) -> List[int]:
        return [f["slice"] for f in self.frames]
