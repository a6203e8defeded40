"""Performance reports with per-metric stats in multiple formats (copy of
heimdall_tpu/perf/reports.py).

Rebuilds rust/heimdall-perf's report layer (reports.rs:8-279): a Report
aggregating count/min/max/avg/stddev per metric, rendered to JSON, text
table, Markdown, HTML, or CSV.
"""

import enum
import json
import statistics
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List


class ReportFormat(enum.Enum):
    JSON = "json"
    TEXT = "text"
    MARKDOWN = "markdown"
    HTML = "html"
    CSV = "csv"


@dataclass
class MetricStats:
    name: str
    metric_type: str
    unit: str
    count: int
    minimum: float
    maximum: float
    average: float
    stddev: float


@dataclass
class Report:
    name: str
    generated_at: float
    stats: List[MetricStats]
    counters: Dict[str, int] = field(default_factory=dict)

    @classmethod
    def from_session(cls, session) -> "Report":
        groups: Dict[str, List] = {}
        meta: Dict[str, Any] = {}
        for m in session.measurements:
            groups.setdefault(m.name, []).append(m.value)
            meta[m.name] = (m.metric_type, m.unit)
        stats = []
        for name, values in groups.items():
            metric_type, unit = meta[name]
            stats.append(MetricStats(
                name=name, metric_type=metric_type, unit=unit,
                count=len(values), minimum=min(values), maximum=max(values),
                average=statistics.mean(values),
                stddev=statistics.stdev(values) if len(values) > 1 else 0.0))
        return cls(name=session.name, generated_at=time.time(), stats=stats,
                   counters=dict(session.counters))

    # ------------------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "generated_at": self.generated_at,
            "counters": self.counters,
            "metrics": [vars(s) for s in self.stats],
        }

    def render(self, fmt: ReportFormat = ReportFormat.TEXT) -> str:
        if fmt == ReportFormat.JSON:
            return json.dumps(self.to_dict(), indent=2)
        if fmt == ReportFormat.CSV:
            lines = ["name,type,unit,count,min,max,avg,stddev"]
            for s in self.stats:
                lines.append(f"{s.name},{s.metric_type},{s.unit},{s.count},"
                             f"{s.minimum:.6g},{s.maximum:.6g},"
                             f"{s.average:.6g},{s.stddev:.6g}")
            return "\n".join(lines)
        if fmt == ReportFormat.MARKDOWN:
            lines = [f"# Performance report: {self.name}", "",
                     "| metric | type | unit | count | min | max | avg "
                     "| stddev |",
                     "|---|---|---|---|---|---|---|---|"]
            for s in self.stats:
                lines.append(
                    f"| {s.name} | {s.metric_type} | {s.unit} | {s.count} "
                    f"| {s.minimum:.4g} | {s.maximum:.4g} "
                    f"| {s.average:.4g} | {s.stddev:.4g} |")
            if self.counters:
                lines += ["", "## Counters", ""]
                lines += [f"- {k}: {v}" for k, v in self.counters.items()]
            return "\n".join(lines)
        if fmt == ReportFormat.HTML:
            rows = "".join(
                f"<tr><td>{s.name}</td><td>{s.metric_type}</td>"
                f"<td>{s.unit}</td><td>{s.count}</td>"
                f"<td>{s.minimum:.4g}</td><td>{s.maximum:.4g}</td>"
                f"<td>{s.average:.4g}</td><td>{s.stddev:.4g}</td></tr>"
                for s in self.stats)
            return (f"<html><body><h1>{self.name}</h1><table border='1'>"
                    "<tr><th>metric</th><th>type</th><th>unit</th>"
                    "<th>count</th><th>min</th><th>max</th><th>avg</th>"
                    f"<th>stddev</th></tr>{rows}</table></body></html>")
        # TEXT
        width = max([len(s.name) for s in self.stats] + [6])
        lines = [f"Performance report: {self.name}",
                 f"{'metric'.ljust(width)}  count      min      max      "
                 "avg   stddev  unit"]
        for s in self.stats:
            lines.append(
                f"{s.name.ljust(width)}  {s.count:5d}  {s.minimum:8.3g} "
                f"{s.maximum:8.3g} {s.average:8.3g} {s.stddev:8.3g}  "
                f"{s.unit}")
        for k, v in self.counters.items():
            lines.append(f"counter {k}: {v}")
        return "\n".join(lines)

    def save(self, path: str, fmt: ReportFormat = ReportFormat.JSON) -> None:
        with open(path, "w") as f:
            f.write(self.render(fmt))
