"""Cross-process trace stitching: one request, one merged timeline (the
port's copy of ``gordo_components_tpu/observability/stitch.py``).

- The server, when (and only when) a request carries the negotiated
  ``X-Gordo-Timeline: 1`` header, stamps its completed span timeline into
  the response as a size-capped base64(JSON) header
  (:func:`encode_timeline`); plain clients never pay the bytes.
- A router decodes the header and merges the server's spans into its own
  timeline under its ``route`` stage (:func:`merge_remote`), each span
  tagged with the server's process label, so the Chrome export renders one
  lane per process (``router/router.py``: ``_stitch_response``).
- A timeline over the cap is announced by
  ``X-Gordo-Timeline-Truncated: <bytes>`` instead, and the router pulls it
  from ``/debug/requests/<trace_id>`` when that trace is read
  (``_pull_stitch``).

Clock alignment: the two processes share no ``perf_counter`` epoch, so
remote spans are placed by wall-clock offset (``started_wall`` delta),
then clamped into the router's observed forward window, the one interval
the server's activity provably occupied.
"""

from __future__ import annotations

import base64
import binascii
import json
import os
from typing import Any, Dict, Optional, Tuple

from .spans import Timeline

# request: "1" asks the server to stamp its timeline on the response.
# response: the base64(compact-JSON) timeline itself.
TIMELINE_HEADER = "X-Gordo-Timeline"
# response: emitted INSTEAD of the timeline when it exceeds the size
# cap; the value is the encoded size, the signal for the pull fallback
TIMELINE_TRUNCATED_HEADER = "X-Gordo-Timeline-Truncated"


def max_bytes() -> int:
    """Size cap for the stitched response header (GORDO_TIMELINE_MAX_BYTES,
    default 8 KiB of base64). Headers ride every routed scoring response,
    so a megabatch-wide 200-span timeline must not bloat the hot path —
    past the cap the router pulls instead."""
    try:
        return max(256, int(os.environ.get("GORDO_TIMELINE_MAX_BYTES", 8192)))
    except (TypeError, ValueError):
        return 8192


def encode_timeline(
    timeline: Timeline, cap: Optional[int] = None
) -> Tuple[Optional[str], Optional[int]]:
    """``(header_value, None)`` within the cap, ``(None, encoded_size)``
    past it. base64 keeps the value a single clean ASCII token whatever
    ends up in span attrs or error strings."""
    payload = json.dumps(
        timeline.to_dict(), separators=(",", ":"), default=str
    )
    encoded = base64.b64encode(payload.encode("utf-8")).decode("ascii")
    limit = cap if cap is not None else max_bytes()
    if len(encoded) > limit:
        return None, len(encoded)
    return encoded, None


def decode_timeline(value: str) -> Dict[str, Any]:
    """Inverse of :func:`encode_timeline`; raises ``ValueError`` on
    anything that is not a base64 JSON timeline dict."""
    try:
        payload = base64.b64decode(value.encode("ascii"), validate=True)
        decoded = json.loads(payload.decode("utf-8"))
    except (binascii.Error, UnicodeDecodeError, ValueError) as exc:
        raise ValueError(f"unparseable stitched timeline: {exc}") from None
    if not isinstance(decoded, dict) or "spans" not in decoded:
        raise ValueError("stitched timeline carries no spans")
    return decoded


def align_offset(
    local_started_wall: float,
    remote: Dict[str, Any],
    window_start: float,
    window_end: float,
) -> float:
    """Local-timeline-relative second at which the remote timeline
    starts. Wall-clock delta when it lands inside the forward window
    (same host, or well-synced clocks); otherwise clamped/centered into
    the window — the monotonic bound the router actually observed."""
    duration = max(0.0, float(remote.get("duration_ms", 0.0)) / 1000.0)
    offset = float(remote.get("started", local_started_wall)) - \
        local_started_wall
    slack = 0.002  # scheduling noise either side
    if (
        offset < window_start - slack
        or offset + duration > window_end + slack
    ):
        # clock skew: fall back to the one provable interval. Center the
        # remote activity in the forward window (transport time splits
        # roughly evenly between the two directions).
        offset = window_start + max(
            0.0, (window_end - window_start - duration) / 2.0
        )
    return max(window_start, offset)


def merge_remote(
    timeline: Timeline,
    remote: Dict[str, Any],
    window_start: float,
    window_end: float,
    process: str,
) -> int:
    """Merge a decoded remote timeline into ``timeline`` as process-lane
    ``process``, aligned inside the ``[window_start, window_end]``
    forward window (both local-timeline-relative seconds). Returns the
    number of spans merged. Defensive: one malformed remote span never
    loses the rest."""
    offset = align_offset(
        timeline.started_wall, remote, window_start, window_end
    )
    merged = 0
    for span in remote.get("spans", ()):
        try:
            name = str(span["name"])
            start = offset + float(span.get("start_ms", 0.0)) / 1000.0
            duration = float(span.get("duration_ms", 0.0)) / 1000.0
        except (KeyError, TypeError, ValueError):
            continue
        attrs = {
            k: v for k, v in span.items()
            if k not in ("name", "start_ms", "duration_ms", "thread",
                         "process")
        }
        timeline.add_span_at(
            name, start, duration,
            thread=str(span.get("thread", "")) or "remote",
            process=process, **attrs,
        )
        merged += 1
    for event in remote.get("events", ()):
        try:
            name = str(event["name"])
            rel = offset + float(event.get("t", 0.0))
        except (KeyError, TypeError, ValueError):
            continue
        attrs = {
            k: v for k, v in event.items()
            if k not in ("name", "t", "process")
        }
        timeline.add_event_at(name, rel, process=process, **attrs)
    if merged:
        timeline.meta.setdefault("stitched", []).append(process)
    return merged
