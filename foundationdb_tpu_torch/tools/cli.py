"""The CLI's span and flight-recorder surfaces over the port's globals.

The port's counterpart of the reference package's ``tools/cli.py``
commands that read the span layer and the flight recorder:

  trace-export [--out=PATH] [--include-wall]
                  the span layer as one Perfetto / Chrome trace-event JSON
                  document (flow/trace_export.py), byte-identical for one
                  seed unless --include-wall adds wall milliseconds
  flightrec [--format=json]
                  the flight recorder's captures: their inventory, or the
                  whole artifacts as JSON
  latency [--format=json]
                  per-stage span latency percentiles a role
  help            these lines

``CliProcessor().run_command(line)`` returns the output lines.  It is
synchronous: the port has no event loop.  For the same hub and recorder
each command prints the reference CLI's lines.  ``latency`` takes only the
span layer's branch: the reference's ``--chains`` (its latency-chain
reassembly of trace events) and the Resolver's ``host_fraction`` line
(a gauge of the reference's server, which the port does not have) are left
out.  There is no ``__main__``: the reference's shell opens a simulated
cluster, which the port has none of; the reference's cluster serves the
port's conflict sets (``SimCluster(conflict_set=...)``).
"""

from __future__ import annotations

import json
import shlex
from typing import List

from ..flow.flight_recorder import global_flight_recorder
from ..flow.spans import global_span_hub, span_latency_summary
from ..flow.trace_export import perfetto_json


class CliProcessor:
    """One command in, a list of output lines out."""

    HELP = {
        "flightrec": "flightrec [--format=json] — flight-recorder "
        "captures (triggered black-box windows: time-series deltas, "
        "recent trace events, transition logs); text form lists the "
        "capture inventory, json dumps the artifacts",
        "latency": "latency [--format=json] — per-stage latency "
        "percentiles from the span layer",
        "trace-export": "trace-export [--out=PATH] [--include-wall] — "
        "export the span layer as a Chrome trace-event / Perfetto JSON "
        "artifact (one track per role, pipeline batches as nested "
        "slices); byte-identical across same-seed runs unless "
        "--include-wall adds real-clock durations",
        "help": "help — this text",
    }

    def run_command(self, line: str) -> List[str]:
        try:
            parts = shlex.split(line)
        except ValueError as e:
            return [f"ERROR: {e}"]
        if not parts:
            return []
        cmd, *args = parts
        handler = getattr(self, f"_cmd_{cmd.replace('-', '_')}", None)
        if handler is None:
            return [f"ERROR: unknown command `{cmd}'; type `help' for help"]
        return handler(args)

    def _cmd_help(self, args):
        return [self.HELP[k] for k in sorted(self.HELP)]

    def _cmd_flightrec(self, args):
        rec = global_flight_recorder()
        if args and args[0] == "--format=json":
            doc = {"status": rec.status_section(), "captures": list(rec.captures)}
            return json.dumps(doc, indent=2, default=str).splitlines()
        if not rec.captures:
            counts = rec.trigger_counts
            return ["flight recorder: no captures"
                    + (f" ({sum(counts.values())} triggers suppressed by cooldown)"
                       if counts else "")]
        lines = [f"flight recorder: {len(rec.captures)} capture(s) retained "
                 f"({rec.capture_seq} lifetime)"]
        for cap in rec.captures:
            series = cap.get("timeseries", {})
            n_samples = sum(len(s) for s in series.values())
            lines.append(
                f"  #{cap['capture_seq']} t={cap['time']:.3f} "
                f"{cap['trigger']}: {len(series)} series / "
                f"{n_samples} samples, "
                f"{len(cap.get('recent_events', []))} trace events"
                + (f", detail={cap['detail']}" if cap.get("detail") else ""))
        return lines

    def _cmd_latency(self, args):
        unknown = [a for a in args if a != "--format=json"]
        if unknown:
            return [f"ERROR: latency takes only --format=json, not {' '.join(unknown)}"]
        hub = global_span_hub()
        if not hub.rings:
            return ["latency: no spans recorded"]
        summary = span_latency_summary(hub)
        if "--format=json" in args:
            return json.dumps(summary, indent=2, default=str).splitlines()
        lines = ["per-stage span latency (virtual seconds):"]
        for role, stages in summary.items():
            if not stages:
                continue
            lines.append(f"{role}:")
            for stage, s in stages.items():
                lines.append(
                    f"  {stage:<16} n={s['count']:<5} "
                    f"p50={s['p50']:.6f} p90={s['p90']:.6f} "
                    f"p99={s['p99']:.6f} max={s['max']:.6f}")
        return lines

    def _cmd_trace_export(self, args):
        include_wall = "--include-wall" in args
        out_path = next((a.split("=", 1)[1] for a in args if a.startswith("--out=")), None)
        blob = perfetto_json(include_wall=include_wall)
        if out_path:
            with open(out_path, "w", encoding="utf-8") as f:
                f.write(blob + "\n")
            hub = global_span_hub()
            return [f"wrote {out_path} "
                    f"({sum(len(r) for r in hub.rings.values())} spans, "
                    f"{len(hub.rings)} role tracks)"]
        return [blob]
