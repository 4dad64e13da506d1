"""Render an incident artifact as a human-readable postmortem timeline.

The incident engine (``launcher/incident.py``) writes one
``incident-<ts>.json`` per fault: the causally-ordered event window, the
detect → decide → act → recover milestone chain, SLO timings, and the involved
processes' flight-recorder dumps. This tool is the reader — the postmortem an
operator would otherwise assemble from raw JSONL by hand:

    python -m tpu_resiliency_torch.tools.incident_report incidents/incident-...json
    python -m tpu_resiliency_torch.tools.incident_report incidents/            # newest
    python -m tpu_resiliency_torch.tools.incident_report incidents/ --list
    python -m tpu_resiliency_torch.tools.incident_report ... --events   # full window
    python -m tpu_resiliency_torch.tools.incident_report ... --flight   # ring dumps

Exit 0 on a rendered artifact, 1 on a missing/invalid one — CI smoke legs
assert the exit code (``scripts/smoke_observability.sh``).
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Optional

from tpu_resiliency_torch.tools import SIGPIPE_EXIT, pipe_safe
from tpu_resiliency_torch.launcher.incident import read_incident

_PHASE_TAG = {
    "detect": "DETECT ",
    "decide": "DECIDE ",
    "act": "ACT    ",
    "recover": "RECOVER",
}


def _fmt_s(v) -> str:
    return f"{v:.3f}s" if isinstance(v, (int, float)) else "n/a"


def resolve_artifact(path: str) -> str:
    """A file path is used as-is; a directory resolves to its newest
    ``incident-*.json`` (the artifact an operator usually wants)."""
    if os.path.isdir(path):
        candidates = sorted(
            n for n in os.listdir(path)
            if n.startswith("incident-") and n.endswith(".json")
        )
        if not candidates:
            raise FileNotFoundError(f"no incident-*.json under {path!r}")
        return os.path.join(path, candidates[-1])
    return path


def render(doc: dict, out, show_events: bool = False, show_flight: bool = False) -> None:
    slo = doc.get("slo", {})
    t0 = doc.get("fault_ts") or doc.get("opened_ts") or 0.0
    dur = (doc.get("closed_ts") or t0) - t0
    print(f"incident {doc['id']}  [{doc.get('outcome', '?')}]", file=out)
    print(
        f"  trigger: {doc['trigger']}"
        + (f" — {doc['detail']}" if doc.get("detail") else ""),
        file=out,
    )
    if doc.get("node_id"):
        print(f"  node: {doc['node_id']}", file=out)
    if doc.get("ranks"):
        print(f"  ranks: {doc['ranks']}", file=out)
    if doc.get("trace_id"):
        print(f"  trace: {doc['trace_id']}", file=out)
    print(f"  duration: {dur:.3f}s", file=out)
    print(
        "  slo: detect=" + _fmt_s(slo.get("time_to_detect_s"))
        + " decide=" + _fmt_s(slo.get("time_to_decide_s"))
        + " act=" + _fmt_s(slo.get("time_to_act_s"))
        + " recover=" + _fmt_s(slo.get("time_to_recover_s"))
        + " steps_lost=" + str(slo.get("steps_lost")),
        file=out,
    )

    census = doc.get("census")
    if isinstance(census, dict):
        _render_census(census, out)

    ev_dumps = [
        r for r in doc.get("events", []) if r.get("kind") == "stack_dump"
    ]
    if ev_dumps:
        by_rank = {}
        for d in ev_dumps:
            by_rank.setdefault(d.get("rank"), []).append(d)
        print(
            f"\nstack dumps in window: {len(ev_dumps)} "
            + ", ".join(
                f"rank {r}: {len(ds)} ({ds[-1].get('reason')})"
                for r, ds in sorted(by_rank.items(), key=lambda kv: str(kv[0]))
            ),
            file=out,
        )

    chain = doc.get("chain", [])
    print(f"\ncausal chain ({len(chain)} milestones):", file=out)
    for m in chain:
        ts = m.get("ts")
        rel = f"t+{ts - t0:8.3f}s" if isinstance(ts, (int, float)) else " " * 11
        rank = f" r{m['rank']}" if m.get("rank") is not None else ""
        print(
            f"  {rel} {_PHASE_TAG.get(m.get('phase'), '?      ')} "
            f"[{m.get('source', '?')}{rank}] {m.get('kind')}: "
            f"{m.get('summary', '')}",
            file=out,
        )
    if not chain:
        print("  (none classified)", file=out)

    flights = doc.get("flight") or {}
    if flights:
        print(f"\nflight recorders ({len(flights)} process(es)):", file=out)
        for ident, records in sorted(flights.items()):
            reasons = [
                r.get("reason") for r in records if r.get("kind") == "flight_flush"
            ]
            dumps = [r for r in records if r.get("kind") == "stack_dump"]
            if dumps:
                n_threads = sum(
                    d.get("thread_count") or len(d.get("threads") or [])
                    for d in dumps
                )
                print(
                    f"  flight-{ident}: {len(dumps)} stack dump(s) "
                    f"({n_threads} thread stacks) — reasons "
                    f"{[d.get('reason') for d in dumps]}",
                    file=out,
                )
            span = ""
            tss = [r["ts"] for r in records if isinstance(r.get("ts"), (int, float))]
            if tss:
                span = f", {max(tss) - min(tss):.1f}s window"
            print(
                f"  flight-{ident}: {len(records)} records{span}"
                + (f", flushes: {reasons}" if reasons else " (segments only — "
                   "process died without a flush, e.g. SIGKILL)"),
                file=out,
            )
            if show_flight:
                for r in records:
                    ts = r.get("ts")
                    rel = (
                        f"t+{ts - t0:8.3f}s"
                        if isinstance(ts, (int, float)) else " " * 11
                    )
                    extras = {
                        k: v for k, v in r.items()
                        if k not in ("ts", "source", "kind", "pid", "rank",
                                     "trace_id", "span_id")
                    }
                    print(
                        f"      {rel} [{r.get('source', '?')}] "
                        f"{r.get('kind')} "
                        + " ".join(f"{k}={v}" for k, v in extras.items()),
                        file=out,
                    )

    if show_events:
        from tpu_resiliency_torch.tools.events_summary import format_line

        evs = doc.get("events", [])
        print(f"\nevent window ({len(evs)} records):", file=out)
        for r in evs:
            if isinstance(r.get("ts"), (int, float)) and r.get("kind"):
                print("  " + format_line(r, t0), file=out)


def _render_census(census: dict, out) -> None:
    """The hang-census table: who was stuck where, who never arrived."""
    ranks = census.get("ranks") or []
    barriers = census.get("barriers") or []
    suspects = census.get("suspects") or []
    print(f"\nhang census ({len(ranks)} rank(s), "
          f"{len(barriers)} open barrier(s)):", file=out)
    for r in ranks:
        stuck = r.get("stuck_s")
        stuck_s = f"{stuck:.1f}s" if isinstance(stuck, (int, float)) else "?"
        flags = []
        if r.get("kill_pending"):
            flags.append("KILL-PENDING")
        if r.get("terminated"):
            flags.append("TERMINATED")
        print(
            f"  rank {r.get('rank')} (pid {r.get('pid')}): stuck {stuck_s}"
            + (f" — {r['where']}" if r.get("where") else "")
            + (f" [{' '.join(flags)}]" if flags else ""),
            file=out,
        )
    for b in barriers:
        arrived = b.get("arrived") or {}
        waiters = ", ".join(
            f"r{k}({v:.0f}s)" if isinstance(v, (int, float)) else f"r{k}"
            for k, v in sorted(arrived.items(), key=lambda kv: str(kv[0]))
        )
        print(
            f"  barrier {b.get('name')}: {len(arrived)}/{b.get('world_size')} "
            f"arrived [{waiters}]"
            + (f", never arrived {b['missing']}" if b.get("missing") else "")
            + (f", absent {b['absent']}" if b.get("absent") else ""),
            file=out,
        )
    if suspects:
        print("  suspects:", file=out)
        for s in suspects:
            why = "; ".join(s.get("reasons") or [])
            print(f"    rank {s.get('rank')} (score {s.get('score')}): {why}",
                  file=out)


def _list(directory: str, out) -> int:
    rows = []
    for n in sorted(os.listdir(directory)):
        if not (n.startswith("incident-") and n.endswith(".json")):
            continue
        try:
            doc = read_incident(os.path.join(directory, n))
        except (OSError, ValueError) as e:
            rows.append((n, f"INVALID: {e}"))
            continue
        slo = doc.get("slo", {})
        rows.append((
            n,
            f"{doc.get('trigger')} [{doc.get('outcome')}] "
            f"detect={_fmt_s(slo.get('time_to_detect_s'))} "
            f"recover={_fmt_s(slo.get('time_to_recover_s'))}",
        ))
    if not rows:
        print(f"no incidents under {directory}", file=sys.stderr)
        return 1
    for name, desc in rows:
        print(f"{name}  {desc}", file=out)
    return 0


def main(argv: Optional[list[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="Render a tpu-resiliency incident artifact as a "
        "postmortem timeline"
    )
    ap.add_argument(
        "artifact",
        help="incident-<ts>.json file, or a directory (newest artifact; "
        "--list shows all)",
    )
    ap.add_argument(
        "--list", action="store_true",
        help="list every artifact in the directory with one-line verdicts",
    )
    ap.add_argument(
        "--events", action="store_true",
        help="also print the full event window",
    )
    ap.add_argument(
        "--flight", action="store_true",
        help="also print each flight-recorder dump line by line",
    )
    args = ap.parse_args(argv)
    if args.list:
        if not os.path.isdir(args.artifact):
            print(f"--list needs a directory, got {args.artifact!r}", file=sys.stderr)
            return 1
        return _list(args.artifact, sys.stdout)
    try:
        path = resolve_artifact(args.artifact)
        doc = read_incident(path)
    except (OSError, ValueError) as e:
        print(f"cannot read incident artifact: {e}", file=sys.stderr)
        return 1
    if pipe_safe(
        lambda: render(
            doc, sys.stdout, show_events=args.events, show_flight=args.flight
        )
    ):
        return SIGPIPE_EXIT
    return 0


if __name__ == "__main__":
    sys.exit(main())
