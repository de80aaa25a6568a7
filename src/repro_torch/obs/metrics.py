"""Counter/gauge/histogram registry with Prometheus-style exposition.

The registry is deliberately small and allocation-light: a *family* is
one metric name + label schema; ``family.labels(...)`` returns a child
whose ``inc`` / ``set`` / ``observe`` is a couple of attribute writes,
so hot-path hooks can pre-bind children and pay no per-event lookup.
``expose()`` renders the whole registry in the Prometheus text format
and ``snapshot()`` returns a JSON-safe dict (histogram ``+Inf`` bucket
bounds become the string ``"+Inf"``); both can be taken mid-run.
"""
from __future__ import annotations

import re
from bisect import bisect_left
from typing import Dict, List, Optional, Sequence, Tuple

COUNTER = "counter"
GAUGE = "gauge"
HISTOGRAM = "histogram"

DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                   1.0, 2.5, 5.0, 10.0, 30.0, 60.0)


class _Child:
    """One labeled time series of a counter or gauge family."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        self.value += amount

    def set(self, value: float) -> None:
        self.value = value


class _HistChild:
    """One labeled histogram series: bucket counts + sum + count."""

    __slots__ = ("bounds", "counts", "sum", "count")

    def __init__(self, bounds: Sequence[float]):
        self.bounds = tuple(bounds)
        self.counts = [0] * (len(self.bounds) + 1)  # last = +Inf
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        self.counts[bisect_left(self.bounds, v)] += 1
        self.sum += v
        self.count += 1


class _Family:
    def __init__(self, name: str, help_text: str, kind: str,
                 labelnames: Sequence[str],
                 buckets: Optional[Sequence[float]] = None):
        self.name = name
        self.help = help_text
        self.kind = kind
        self.labelnames = tuple(labelnames)
        self.buckets = tuple(buckets) if buckets is not None else None
        self._children: Dict[Tuple[str, ...], object] = {}

    def labels(self, *labelvalues: str):
        key = tuple(str(v) for v in labelvalues)
        if len(key) != len(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, got {key}")
        child = self._children.get(key)
        if child is None:
            child = (_HistChild(self.buckets) if self.kind == HISTOGRAM
                     else _Child())
            self._children[key] = child
        return child

    # -- rendering -----------------------------------------------------

    @staticmethod
    def _fmt_labels(names: Tuple[str, ...], values: Tuple[str, ...],
                    extra: str = "") -> str:
        parts = [f'{n}="{v}"' for n, v in zip(names, values)]
        if extra:
            parts.append(extra)
        return "{" + ",".join(parts) + "}" if parts else ""

    def expose(self) -> List[str]:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} {self.kind}"]
        for key in sorted(self._children):
            child = self._children[key]
            if self.kind == HISTOGRAM:
                cum = 0
                for bound, n in zip(list(child.bounds) + ["+Inf"],
                                    child.counts):
                    cum += n
                    le = bound if bound == "+Inf" else repr(float(bound))
                    lab = self._fmt_labels(self.labelnames, key,
                                           f'le="{le}"')
                    lines.append(f"{self.name}_bucket{lab} {cum}")
                lab = self._fmt_labels(self.labelnames, key)
                lines.append(f"{self.name}_sum{lab} {child.sum!r}")
                lines.append(f"{self.name}_count{lab} {child.count}")
            else:
                lab = self._fmt_labels(self.labelnames, key)
                v = child.value
                out = repr(float(v)) if isinstance(v, float) else str(v)
                lines.append(f"{self.name}{lab} {out}")
        return lines

    def snapshot(self) -> dict:
        series = []
        for key in sorted(self._children):
            child = self._children[key]
            labels = dict(zip(self.labelnames, key))
            if self.kind == HISTOGRAM:
                buckets = {}
                for bound, n in zip(list(child.bounds) + ["+Inf"],
                                    child.counts):
                    buckets[str(bound)] = n
                series.append({"labels": labels, "buckets": buckets,
                               "sum": child.sum, "count": child.count})
            else:
                series.append({"labels": labels, "value": child.value})
        return {"type": self.kind, "help": self.help, "series": series}


class MetricsRegistry:
    """Named metric families, snapshotable mid-run."""

    def __init__(self) -> None:
        self._families: Dict[str, _Family] = {}

    def _family(self, name: str, help_text: str, kind: str,
                labelnames: Sequence[str],
                buckets: Optional[Sequence[float]] = None) -> _Family:
        fam = self._families.get(name)
        if fam is None:
            fam = _Family(name, help_text, kind, labelnames, buckets)
            self._families[name] = fam
        elif fam.kind != kind or fam.labelnames != tuple(labelnames):
            raise ValueError(f"metric {name!r} re-registered with a "
                             f"different type or label schema")
        return fam

    def counter(self, name: str, help_text: str = "",
                labelnames: Sequence[str] = ()) -> _Family:
        return self._family(name, help_text, COUNTER, labelnames)

    def gauge(self, name: str, help_text: str = "",
              labelnames: Sequence[str] = ()) -> _Family:
        return self._family(name, help_text, GAUGE, labelnames)

    def histogram(self, name: str, help_text: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> _Family:
        return self._family(name, help_text, HISTOGRAM, labelnames, buckets)

    def expose(self) -> str:
        """The whole registry in Prometheus text exposition format."""
        lines: List[str] = []
        for name in sorted(self._families):
            lines.extend(self._families[name].expose())
        return "\n".join(lines) + ("\n" if lines else "")

    def snapshot(self) -> dict:
        """JSON-safe dump of every family (taken mid-run is fine)."""
        return {name: fam.snapshot()
                for name, fam in sorted(self._families.items())}


_SAMPLE_RE = re.compile(
    r"^(?P<name>[A-Za-z_:][A-Za-z0-9_:]*)"
    r"(?:\{(?P<labels>[^}]*)\})?\s+(?P<value>\S+)$")
_LABEL_RE = re.compile(r'([A-Za-z_][A-Za-z0-9_]*)="([^"]*)"')


def parse_exposition(text: str) -> Dict[str, Dict[Tuple[Tuple[str, str], ...],
                                                  float]]:
    """Parse Prometheus text exposition back into
    ``{metric name: {sorted (label, value) pairs: sample value}}`` —
    the round-trip counterpart of :meth:`MetricsRegistry.expose`,
    used by the exposition round-trip test."""
    out: Dict[str, Dict[Tuple[Tuple[str, str], ...], float]] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"unparseable exposition line: {line!r}")
        labels = tuple(sorted(_LABEL_RE.findall(m.group("labels") or "")))
        out.setdefault(m.group("name"), {})[labels] = float(m.group("value"))
    return out
