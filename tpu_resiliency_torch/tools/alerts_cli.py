"""``tpu-alerts``: render watchtower alert state — live, or by offline replay.

Three modes over one engine (``telemetry/watchtower.py``):

- ``tpu-alerts --url http://host:port`` fetches the live ``GET /alerts``
  document (``tpu-alerts-1``) and renders the rule table, active alerts, and
  recent fire/resolve history.
- ``tpu-alerts events.jsonl`` replays a finished events stream through the
  same engine offline. The watchtower runs on stream time, so the replayed
  (rule, fire_ts, resolve_ts) sequence is byte-identical to what the live run
  emitted — a postmortem needs no running job. ``--json`` prints the sequence
  as one JSON object per line (sorted keys), the byte-comparison surface the
  chaos campaign and the smoke check diff against the live record.
- ``tpu-alerts --rules`` renders the effective rule table (built-ins with any
  ``$TPU_RESILIENCY_ALERT_RULES`` overrides applied) without a job at all.

Usage::

    tpu-alerts --url http://127.0.0.1:9300
    tpu-alerts run/events.jsonl
    tpu-alerts run/events.jsonl --json | diff - expected.jsonl
    tpu-alerts --rules
"""

from __future__ import annotations

import argparse
import json
import sys
import urllib.request
from typing import List, Optional

from tpu_resiliency_torch.telemetry.watchtower import (
    ALERTS_SCHEMA,
    default_rules,
    load_rule_overrides,
    replay,
)
from tpu_resiliency_torch.tools import SIGPIPE_EXIT, pipe_safe


def _fmt_ts(v) -> str:
    return f"{v:.3f}" if isinstance(v, (int, float)) else "-"


def _table(rows: list, header: list, out) -> None:
    widths = [
        max(len(str(r[i])) for r in [header] + rows) for i in range(len(header))
    ]
    line = "  ".join(str(h).ljust(w) for h, w in zip(header, widths))
    print(line, file=out)
    print("-" * len(line), file=out)
    for r in rows:
        print("  ".join(str(c).ljust(w) for c, w in zip(r, widths)), file=out)


def load_events(path: str) -> List[dict]:
    """The events JSONL, torn-tail tolerant: a half-written last line (the
    writer died mid-record) is skipped, not fatal — postmortem streams end
    however the job ended."""
    records: List[dict] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(rec, dict):
                records.append(rec)
    return records


def render_doc(doc: dict, out=None) -> None:
    out = sys.stdout if out is None else out
    clock = doc.get("clock") or {}
    print(
        f"watchtower{' job=' + doc['job'] if doc.get('job') else ''}: "
        f"hwm={_fmt_ts(clock.get('hwm'))} evals={clock.get('evals', 0)} "
        f"interval={clock.get('eval_interval', '-')}s",
        file=out,
    )
    if doc.get("config_error"):
        print(f"config error: {doc['config_error']}", file=out)
    rows = []
    for r in doc.get("rules") or []:
        rows.append([
            r.get("name", "?"), r.get("severity", "?"), r.get("state", "?"),
            f"{r.get('for_s', 0):g}s", r.get("fired_total", 0),
            r.get("error") or r.get("detail") or "",
        ])
    if rows:
        _table(rows, ["rule", "severity", "state", "for", "fired", "detail"], out)
    active = doc.get("active") or []
    print(f"{len(active)} active alert(s)", file=out)
    for a in active:
        print(
            f"  [{a.get('severity', '?')}] {a.get('rule', '?')} since "
            f"{_fmt_ts(a.get('fire_ts'))}: {a.get('detail')}",
            file=out,
        )
    history = doc.get("history") or []
    if history:
        print(f"last {len(history)} transition(s):", file=out)
        for tr in history:
            print("  " + transition_phrase(tr), file=out)


def transition_phrase(tr: dict) -> str:
    kind = tr.get("kind", "?")
    base = (
        f"{kind} rule={tr.get('rule', '?')} sev={tr.get('severity', '?')} "
        f"at {_fmt_ts(tr.get('fire_ts') if kind == 'alert_fired' else tr.get('resolve_ts'))}"
    )
    if kind == "alert_resolved":
        base += f" after {tr.get('duration_s', '?')}s"
    detail = tr.get("detail")
    return base + (f": {detail}" if detail else "")


def render_rules(out=None) -> None:
    out = sys.stdout if out is None else out
    overrides, err = load_rule_overrides()
    if err:
        print(f"override file error (built-ins apply): {err}", file=out)
    rows = [
        [r.name, r.severity, f"{r.for_s:g}s",
         json.dumps(r.params, sort_keys=True)]
        for r in default_rules(overrides)
    ]
    _table(rows, ["rule", "severity", "for", "params"], out)


def fetch_doc(url: str) -> dict:
    with urllib.request.urlopen(f"{url.rstrip('/')}/alerts", timeout=10) as r:
        doc = json.load(r)
    if not isinstance(doc, dict) or doc.get("schema") != ALERTS_SCHEMA:
        raise ValueError(
            f"not a {ALERTS_SCHEMA} document "
            f"(got schema {doc.get('schema') if isinstance(doc, dict) else None!r})"
        )
    return doc


def main(argv: Optional[list[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="tpu-alerts",
        description="Render watchtower alerts from a live job's /alerts "
        "endpoint, or reproduce the exact fire/resolve sequence offline by "
        "replaying an events JSONL through the same engine.",
    )
    ap.add_argument(
        "events", nargs="?", default=None,
        help="events JSONL to replay offline (the run's shared stream)",
    )
    ap.add_argument(
        "--url", default=None,
        help="live telemetry base URL (fetches /alerts instead of replaying)",
    )
    ap.add_argument(
        "--rules", action="store_true",
        help="render the effective rule table (built-ins + "
        "$TPU_RESILIENCY_ALERT_RULES overrides) and exit",
    )
    ap.add_argument(
        "--json", action="store_true",
        help="machine output: the raw /alerts document (--url), or the "
        "replayed transition sequence as one sorted-key JSON object per "
        "line (events replay — the byte-comparison surface)",
    )
    ap.add_argument(
        "--eval-interval", type=float, default=5.0,
        help="replay stream-clock boundary spacing in seconds (default 5.0; "
        "must match the live run's for sequences to compare equal)",
    )
    args = ap.parse_args(argv)
    if args.rules:
        return SIGPIPE_EXIT if pipe_safe(render_rules) else 0
    if bool(args.events) == bool(args.url):
        print("exactly one of <events.jsonl> / --url is required "
              "(or --rules)", file=sys.stderr)
        return 2

    if args.url:
        try:
            doc = fetch_doc(args.url)
        except (OSError, ValueError, json.JSONDecodeError) as e:
            print(f"cannot fetch /alerts: {e}", file=sys.stderr)
            return 1

        def emit() -> None:
            if args.json:
                json.dump(doc, sys.stdout, indent=2, sort_keys=True)
                print()
            else:
                render_doc(doc)

        return SIGPIPE_EXIT if pipe_safe(emit) else 0

    try:
        records = load_events(args.events)
    except OSError as e:
        print(f"cannot read events: {e}", file=sys.stderr)
        return 1
    tower, sequence = replay(records, eval_interval=args.eval_interval)

    def emit() -> None:
        if args.json:
            for tr in sequence:
                print(json.dumps(tr, sort_keys=True))
        else:
            print(
                f"replayed {len(records)} record(s): "
                f"{len(sequence)} transition(s)"
            )
            for tr in sequence:
                print("  " + transition_phrase(tr))
            render_doc(tower.status())

    return SIGPIPE_EXIT if pipe_safe(emit) else 0


if __name__ == "__main__":
    sys.exit(main())
