"""Multi-tenant QoS: tenant identity, quotas and priority classes (the
port's copy of ``gordo_components_tpu/resilience/qos.py``).

- A **tenant** is a named principal with a priority **class**
  (``interactive`` > ``standard`` > ``bulk``) and an optional token-bucket
  **quota** (rate/burst). The table is declared up front (``GORDO_TENANTS``
  / ``--tenants``).
- Requests carry ``X-Gordo-Tenant`` (a tenant name, or a declared API key);
  bare requests and unknown values fold into the ``default`` tenant, so
  every ``tenant``-labeled metric family is bounded by the table.
- A context variable carries the resolved tenant through the request's
  thread, so the engine reads the class at submit time without a
  parameter through every layer.
- The raw header values seen are counted in a Space-Saving sketch
  (``observability/traffic.py``), so ``/tenants`` shows the top unmapped
  principals in bounded memory.

Token buckets take an injectable monotonic clock: quota tests run hours of
refill arithmetic with no sleep.
"""

from __future__ import annotations

import contextvars
import math
import os
import time
from dataclasses import dataclass, replace
from typing import Callable, Dict, List, Optional, Tuple

from ..analysis import lockcheck
from ..observability.registry import REGISTRY
from ..observability.traffic import SpaceSaving

# priority classes, highest first; rank orders shedding (lowest class
# sheds first) and the weighted fill interleave
CLASSES = ("interactive", "standard", "bulk")
CLASS_RANK = {name: rank for rank, name in enumerate(CLASSES)}
DEFAULT_CLASS = "standard"
DEFAULT_TENANT = "default"

# request header carrying the tenant name or a declared API key; the
# router forwards it untouched (it is not hop-by-hop), so one stamp at
# the client reaches the worker gate
TENANT_HEADER = "X-Gordo-Tenant"

# the autopilot shed ladder's top rung: at shed level SHED_MAX the bulk
# class's admission share reaches zero (bulk fully shed)
SHED_MAX = 8

_M_TENANT = REGISTRY.counter(
    "gordo_tenant_requests_total",
    "Per-tenant request outcomes at the admission seam (ok / quota / "
    "shed / error); tenant label values come from the declared table "
    "plus 'default', so cardinality is bounded by configuration",
    labels=("tenant", "class", "outcome"),
)


def note_request(tenant: str, klass: str, outcome: str) -> None:
    """One bounded per-tenant accounting increment (tenant/class come
    from the closed table, outcome is a closed enum)."""
    _M_TENANT.labels(tenant, klass, outcome).inc()


def _env_str(name: str, default: str) -> str:
    value = os.environ.get(name)
    return value.strip() if value and value.strip() else default


def normalize_class(name: Optional[str]) -> str:
    name = (name or "").strip().lower()
    return name if name in CLASS_RANK else DEFAULT_CLASS


def default_class() -> str:
    """``GORDO_QOS_DEFAULT_CLASS``: the class bare/unknown requests get."""
    return normalize_class(_env_str("GORDO_QOS_DEFAULT_CLASS", DEFAULT_CLASS))


def class_weights() -> Dict[str, float]:
    """``GORDO_QOS_WEIGHTS`` (``interactive=8,standard=4,bulk=1``): the
    deficit-weighted fill shares. Malformed entries fall back to the
    shipped weights — a typo'd knob degrades, never crashes the boot."""
    weights = {"interactive": 8.0, "standard": 4.0, "bulk": 1.0}
    spec = os.environ.get("GORDO_QOS_WEIGHTS", "")
    for part in spec.replace(";", ",").split(","):
        part = part.strip()
        if not part or "=" not in part:
            continue
        key, _, value = part.partition("=")
        key = normalize_class(key) if key.strip().lower() in CLASS_RANK \
            else None
        if key is None:
            continue
        try:
            weights[key] = max(1.0, float(value))
        except ValueError:
            continue
    return weights


# -- token bucket -------------------------------------------------------------
class TokenBucket:
    """Classic token bucket: ``rate`` tokens/second refill up to
    ``burst`` capacity. ``rate <= 0`` means unlimited (every take
    succeeds). Not thread-safe on its own — the owning
    :class:`TenantTable` serializes access under its lock."""

    __slots__ = ("rate", "burst", "_tokens", "_last", "_clock")

    def __init__(
        self,
        rate: float,
        burst: float,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.rate = float(rate)
        self.burst = max(1.0, float(burst))
        self._tokens = self.burst
        self._last = clock()
        self._clock = clock

    def _refill(self, now: float) -> None:
        elapsed = max(0.0, now - self._last)
        self._last = now
        if self.rate > 0:
            self._tokens = min(self.burst, self._tokens + elapsed * self.rate)

    def take(self, n: float = 1.0) -> bool:
        if self.rate <= 0:
            return True
        now = self._clock()
        self._refill(now)
        if self._tokens >= n:
            self._tokens -= n
            return True
        return False

    def seconds_until(self, n: float = 1.0) -> float:
        """How long until ``n`` tokens will be available — the honest
        ``Retry-After`` a quota-exhausted response carries."""
        if self.rate <= 0:
            return 0.0
        self._refill(self._clock())
        missing = n - self._tokens
        if missing <= 0:
            return 0.0
        return missing / self.rate

    @property
    def tokens(self) -> float:
        self._refill(self._clock())
        return self._tokens


# -- tenant table -------------------------------------------------------------
@dataclass(frozen=True)
class TenantSpec:
    """One declared principal: name, priority class, quota (``rate``
    requests/second refilling a ``burst``-deep bucket; rate 0 =
    unlimited), and an optional API ``key`` the header may carry
    instead of the name."""

    name: str
    klass: str = DEFAULT_CLASS
    rate: float = 0.0
    burst: float = 1.0
    key: Optional[str] = None


def parse_tenants(spec: Optional[str]) -> List[TenantSpec]:
    """``name:class[:rate[:burst[:key]]]`` entries, ``;``/``,``
    separated — e.g. ``dash:interactive;etl:bulk:50:100:s3cret``.
    Malformed entries raise ``ValueError`` so a typo'd ``--tenants``
    fails the command loudly instead of silently dropping a quota."""
    out: List[TenantSpec] = []
    seen = set()
    if not spec or not spec.strip():
        return out
    for entry in spec.replace(";", ",").split(","):
        entry = entry.strip()
        if not entry:
            continue
        parts = entry.split(":")
        name = parts[0].strip()
        if not name:
            raise ValueError(f"tenant entry {entry!r} has no name")
        if name in seen:
            raise ValueError(f"tenant {name!r} declared twice")
        seen.add(name)
        klass = (parts[1].strip().lower() if len(parts) > 1 and
                 parts[1].strip() else DEFAULT_CLASS)
        if klass not in CLASS_RANK:
            raise ValueError(
                f"tenant {name!r}: unknown class {klass!r} "
                f"(one of {', '.join(CLASSES)})"
            )
        rate = 0.0
        burst = 0.0
        if len(parts) > 2 and parts[2].strip():
            try:
                rate = float(parts[2])
            except ValueError:
                raise ValueError(
                    f"tenant {name!r}: rate {parts[2]!r} is not a number"
                )
        if len(parts) > 3 and parts[3].strip():
            try:
                burst = float(parts[3])
            except ValueError:
                raise ValueError(
                    f"tenant {name!r}: burst {parts[3]!r} is not a number"
                )
        key = parts[4].strip() if len(parts) > 4 and parts[4].strip() \
            else None
        out.append(TenantSpec(
            name=name,
            klass=klass,
            rate=max(0.0, rate),
            burst=burst if burst > 0 else max(1.0, rate),
            key=key,
        ))
    return out


class TenantTable:
    """The resolved tenant map + per-tenant token buckets.

    ``resolve`` is the per-request hot path: two dict probes. Bucket
    mutation happens under the table lock (hot: no blocking call
    inside). The raw-header sketch bounds what
    an adversarial client spraying random tenant names can cost."""

    def __init__(
        self,
        tenants: Optional[List[TenantSpec]] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        specs = list(tenants or [])
        self._clock = clock
        self._lock = lockcheck.named_lock("resilience.qos")
        self._by_name: Dict[str, TenantSpec] = {t.name: t for t in specs}
        self._by_key: Dict[str, TenantSpec] = {
            t.key: t for t in specs if t.key
        }
        self.default = self._by_name.get(DEFAULT_TENANT) or TenantSpec(
            DEFAULT_TENANT, klass=default_class()
        )
        self._by_name.setdefault(DEFAULT_TENANT, self.default)
        self._buckets: Dict[str, TokenBucket] = {
            t.name: TokenBucket(t.rate, t.burst, clock)
            for t in self._by_name.values() if t.rate > 0
        }
        self._header_sketch = SpaceSaving(64)

    @classmethod
    def from_env(
        cls, clock: Callable[[], float] = time.monotonic
    ) -> "TenantTable":
        return cls(parse_tenants(os.environ.get("GORDO_TENANTS")), clock)

    def __len__(self) -> int:
        return len(self._by_name)

    def resolve(self, header_value: Optional[str]) -> TenantSpec:
        """Header value → declared tenant (by name, then by API key);
        absent/unknown → the default tenant. Every path is O(1)."""
        if not header_value:
            return self.default
        value = header_value.strip()
        spec = self._by_name.get(value)
        if spec is None:
            spec = self._by_key.get(value)
        with self._lock:
            lockcheck.assert_guard("resilience.qos")
            self._header_sketch.offer(value if spec is None else spec.name)
        return spec if spec is not None else self.default

    def take(self, spec: TenantSpec) -> Tuple[bool, float]:
        """Charge one request against ``spec``'s quota bucket. Returns
        ``(admitted, retry_after_seconds)`` — retry_after is 0 when
        admitted or unlimited."""
        bucket = self._buckets.get(spec.name)
        if bucket is None:
            return True, 0.0
        with self._lock:
            lockcheck.assert_guard("resilience.qos")
            if bucket.take():
                return True, 0.0
            return False, max(0.05, bucket.seconds_until())

    def specs(self) -> List[TenantSpec]:
        return sorted(self._by_name.values(), key=lambda t: t.name)

    def snapshot(self) -> Dict[str, object]:
        """The ``/tenants`` body: declared table (keys redacted), live
        bucket levels, and the top raw header values seen."""
        with self._lock:
            levels = {
                name: round(bucket.tokens, 3)
                for name, bucket in self._buckets.items()
            }
            seen = [
                {"value": value, "count": count, "error": error}
                for value, count, error in self._header_sketch.top(8)
            ]
        return {
            "tenants": [
                {
                    "name": t.name,
                    "class": t.klass,
                    "rate": t.rate,
                    "burst": t.burst,
                    "has_key": bool(t.key),
                    "tokens": levels.get(t.name),
                }
                for t in self.specs()
            ],
            "default_class": self.default.klass,
            "header_values_seen": seen,
        }


# -- request-scoped tenant ----------------------------------------------------
_TENANT: contextvars.ContextVar[Optional[TenantSpec]] = \
    contextvars.ContextVar("gordo_tenant", default=None)


def set_current(spec: Optional[TenantSpec]):
    """Bind the resolved tenant to this request's context; returns the
    reset token (``finally: reset(token)`` in the WSGI layer)."""
    return _TENANT.set(spec)


def reset(token) -> None:
    _TENANT.reset(token)


def current() -> Optional[TenantSpec]:
    return _TENANT.get()


def current_class() -> str:
    spec = _TENANT.get()
    return spec.klass if spec is not None else DEFAULT_CLASS


def as_class(spec: TenantSpec, klass: str) -> TenantSpec:
    """The same tenant at a different priority class — the bulk scoring
    endpoint forces ``bulk`` whatever class the tenant declared (quota
    identity, and therefore the token bucket, stays the tenant's own)."""
    if spec.klass == klass:
        return spec
    return replace(spec, klass=klass)


# -- class-aware admission shares ---------------------------------------------
# "Shed lowest class first" as arithmetic, not a priority queue, and
# WITHOUT changing what an untenanted deployment sees: interactive and
# standard keep the full in-flight gate (the default tenant is standard
# — its capacity must stay byte-identical to the single-class gate), so
# ordering comes from two other watermarks. Bulk admits against a
# REDUCED in-flight share (it stops scoring while the higher classes
# still fill the gate), and the bounded QUEUE behind a full gate is
# class-scaled — interactive may use all of it, standard half, bulk a
# quarter — so when the gate saturates, bulk sheds first, standard
# second, interactive holds out longest. The autopilot shed ladder
# scales ONLY the bulk in-flight share (shed_level/SHED_MAX of the way
# to zero).
_CLASS_SHARE = {"interactive": 1.0, "standard": 1.0, "bulk": 0.75}
_QUEUE_SHARE = {"interactive": 1.0, "standard": 0.5, "bulk": 0.25}


def class_limit(max_inflight: int, klass: str, shed_level: int = 0) -> int:
    share = _CLASS_SHARE.get(klass, _CLASS_SHARE[DEFAULT_CLASS])
    if klass == "bulk":
        level = max(0, min(SHED_MAX, int(shed_level)))
        share *= 1.0 - level / float(SHED_MAX)
    limit = int(math.floor(max_inflight * share))
    if klass == "interactive":
        return max(1, limit)
    return max(0, limit)


def queue_limit(max_queue: int, klass: str) -> int:
    """How many of the gate's ``max_queue`` waiter slots this class may
    occupy: past it the class sheds instead of queueing."""
    share = _QUEUE_SHARE.get(klass, _QUEUE_SHARE[DEFAULT_CLASS])
    return max(0, int(math.floor(max_queue * share)))


# -- weighted-fair interleave -------------------------------------------------
def weighted_interleave(
    items: List,
    klass_of: Callable[[object], str],
    weights: Optional[Dict[str, float]] = None,
) -> List:
    """Deficit-weighted round-robin reorder: classes share dispatch
    slots proportionally to their weights while arrival order is kept
    WITHIN each class. Single-class batches return the input list
    untouched (the idle-path cost is one scan), and reordering is
    score-safe by construction — per-item scores are independent under
    vmap, so batch order cannot change any byte of any result."""
    first_class: Optional[str] = None
    mixed = False
    for item in items:
        k = klass_of(item)
        if first_class is None:
            first_class = k
        elif k != first_class:
            mixed = True
            break
    if not mixed:
        return items
    if weights is None:
        weights = class_weights()
    queues: Dict[str, List] = {}
    for item in items:
        queues.setdefault(klass_of(item), []).append(item)
    order = sorted(queues, key=lambda k: CLASS_RANK.get(k, 1))
    deficit = {k: 0.0 for k in order}
    heads = {k: 0 for k in order}
    out: List = []
    while len(out) < len(items):
        for k in order:
            if heads[k] < len(queues[k]):
                deficit[k] += max(1.0, weights.get(k, 1.0))
        for k in order:
            queue = queues[k]
            while deficit[k] >= 1.0 and heads[k] < len(queue):
                out.append(queue[heads[k]])
                heads[k] += 1
                deficit[k] -= 1.0
    return out
