"""Counter / gauge / histogram metric families with Prometheus-style text
exposition.

The fleet's EWMA telemetry answers "what is the level right now"; these
answer "what was the distribution" — fixed log-spaced buckets make the
histograms mergeable across runs and replicas, and percentile estimates
come from the bucket counts (upper-edge rule: monotone, never optimistic
by more than one bucket width).

Bucket boundary semantics are Prometheus ``le``: an observation lands in
the FIRST bucket whose upper edge is >= the value (a value exactly on an
edge belongs to that edge's bucket); everything above the last edge goes
to the +Inf overflow bucket.
"""
from __future__ import annotations

import math
from bisect import bisect_left
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "log_buckets",
           "DEFAULT_TIME_BUCKETS"]


def log_buckets(lo: float, hi: float, per_decade: int = 4) -> Tuple[float, ...]:
    """Fixed log-spaced bucket edges covering [lo, hi] with ``per_decade``
    edges per factor of 10 (both endpoints included)."""
    if lo <= 0 or hi <= lo:
        raise ValueError(f"need 0 < lo < hi, got ({lo}, {hi})")
    if per_decade < 1:
        raise ValueError(f"per_decade must be >= 1, got {per_decade}")
    n = int(math.ceil(math.log10(hi / lo) * per_decade))
    edges = [lo * 10.0 ** (i / per_decade) for i in range(n + 1)]
    edges[-1] = max(edges[-1], hi)
    # round to a stable short decimal so exposition labels are exact across
    # platforms (1.0000000000000002e-2 and 1e-2 must be the same bucket)
    return tuple(float(f"{e:.6g}") for e in edges)


# control-loop / wall seconds from 100us to ~1000s: covers pump walls,
# TTFT, and TPOT on one fixed grid (mergeable across every fleet run)
DEFAULT_TIME_BUCKETS = log_buckets(1e-4, 1e3, per_decade=3)


class Counter:
    """Monotone counter."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counters only go up, got inc({n})")
        self.value += n


class Gauge:
    """Set-to-current-value metric."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, n: float = 1.0) -> None:
        self.value += n


class Histogram:
    """Fixed-bucket histogram with ``le`` (value <= edge) semantics."""

    __slots__ = ("edges", "counts", "sum", "count")

    def __init__(self, buckets: Sequence[float] = DEFAULT_TIME_BUCKETS):
        edges = tuple(sorted(float(b) for b in buckets))
        if not edges:
            raise ValueError("histogram needs at least one bucket edge")
        self.edges = edges
        # counts[i] observes edges[i-1] < v <= edges[i]; counts[-1] is +Inf
        self.counts = [0] * (len(edges) + 1)
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        v = float(v)
        self.counts[bisect_left(self.edges, v)] += 1
        self.sum += v
        self.count += 1

    def percentile(self, q: float) -> float:
        """Upper-edge percentile estimate (q in [0, 100]); 0.0 when empty.
        Observations in the overflow bucket report the largest edge — the
        estimate saturates rather than invents a value."""
        if self.count == 0:
            return 0.0
        target = max(1, math.ceil(q / 100.0 * self.count))
        acc = 0
        for i, c in enumerate(self.counts):
            acc += c
            if acc >= target:
                return self.edges[min(i, len(self.edges) - 1)]
        return self.edges[-1]

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class _Family:
    """One named metric family: children per label-value tuple."""

    def __init__(self, kind: str, name: str, help: str,
                 label_names: Tuple[str, ...],
                 buckets: Optional[Sequence[float]] = None):
        self.kind = kind
        self.name = name
        self.help = help
        self.label_names = label_names
        self._buckets = buckets
        self.children: Dict[Tuple[str, ...], object] = {}

    def labels(self, *values: str):
        if len(values) != len(self.label_names):
            raise ValueError(
                f"{self.name}: expected labels {self.label_names}, "
                f"got {values}")
        key = tuple(str(v) for v in values)
        child = self.children.get(key)
        if child is None:
            child = (Histogram(self._buckets or DEFAULT_TIME_BUCKETS)
                     if self.kind == "histogram" else _KINDS[self.kind]())
            self.children[key] = child
        return child

    # label-less convenience: fam.inc() == fam.labels().inc()
    def inc(self, n: float = 1.0) -> None:
        self.labels().inc(n)

    def set(self, v: float) -> None:
        self.labels().set(v)

    def observe(self, v: float) -> None:
        self.labels().observe(v)

    def _label_str(self, key: Tuple[str, ...],
                   extra: Tuple[Tuple[str, str], ...] = ()) -> str:
        pairs = list(zip(self.label_names, key)) + list(extra)
        if not pairs:
            return ""
        inner = ",".join(f'{k}="{v}"' for k, v in pairs)
        return "{" + inner + "}"

    def exposition(self) -> List[str]:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} {self.kind}"]
        for key in sorted(self.children):
            child = self.children[key]
            if self.kind == "histogram":
                acc = 0
                for edge, c in zip(child.edges, child.counts):
                    acc += c
                    ls = self._label_str(key, (("le", f"{edge:g}"),))
                    lines.append(f"{self.name}_bucket{ls} {acc}")
                ls = self._label_str(key, (("le", "+Inf"),))
                lines.append(f"{self.name}_bucket{ls} {child.count}")
                lines.append(
                    f"{self.name}_sum{self._label_str(key)} {child.sum:g}")
                lines.append(
                    f"{self.name}_count{self._label_str(key)} {child.count}")
            else:
                lines.append(
                    f"{self.name}{self._label_str(key)} {child.value:g}")
        return lines


class MetricsRegistry:
    """Named families; ``exposition()`` renders the Prometheus text form.

    Re-declaring an existing name returns the existing family (so modules
    can declare their metrics independently) but a kind mismatch raises."""

    def __init__(self):
        self._families: Dict[str, _Family] = {}

    def _declare(self, kind: str, name: str, help: str,
                 labels: Iterable[str],
                 buckets: Optional[Sequence[float]] = None) -> _Family:
        fam = self._families.get(name)
        if fam is not None:
            if fam.kind != kind:
                raise ValueError(
                    f"metric {name} already declared as {fam.kind}")
            return fam
        fam = _Family(kind, name, help, tuple(labels), buckets)
        self._families[name] = fam
        return fam

    def counter(self, name: str, help: str = "",
                labels: Iterable[str] = ()) -> _Family:
        return self._declare("counter", name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Iterable[str] = ()) -> _Family:
        return self._declare("gauge", name, help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: Iterable[str] = (),
                  buckets: Optional[Sequence[float]] = None) -> _Family:
        return self._declare("histogram", name, help, labels, buckets)

    def get(self, name: str) -> Optional[_Family]:
        return self._families.get(name)

    def exposition(self) -> str:
        lines: List[str] = []
        for name in sorted(self._families):
            lines.extend(self._families[name].exposition())
        return "\n".join(lines) + ("\n" if lines else "")
