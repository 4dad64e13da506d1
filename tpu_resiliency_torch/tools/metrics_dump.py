"""Aggregate a finished run's events JSONL into metrics.

The post-hoc twin of the live :class:`~tpu_resiliency_torch.utils.metrics.MetricsSink`
— same kind→metric mapping (``utils/metrics.py:observe_record``), replayed over
a JSONL file instead of fed per ``record()`` call, so an operator answers "how
many restarts, p95 rendezvous time, checkpoint save latency" from the artifact
a run leaves behind, without a scrape pipeline and without replaying raw JSONL
by hand.

Usage::

    python -m tpu_resiliency_torch.tools.metrics_dump run_events.jsonl            # report
    python -m tpu_resiliency_torch.tools.metrics_dump run_events.jsonl --format prom
    python -m tpu_resiliency_torch.tools.metrics_dump run_events.jsonl --format json -o m.json
    python -m tpu_resiliency_torch.tools.metrics_dump run_events.jsonl --goodput  # attribution

``--goodput`` renders the time-attribution ledger (``utils/goodput.py``)
instead of the metrics report: wall clock classified into train / ckpt_stall /
restart / incident / unattributed, the goodput ratio, and per-rank rows — the
offline twin of the launcher's live ``/goodput`` endpoint, computed from the
same stream by the same ledger.

``--bytes`` renders the byte-flow ledger (``utils/byteflow.py``) instead:
every byte moved attributed to (purpose, direction, peer) — replicate /
retrieve / reshard / store / ckpt_write — reconciled against the per-family
byte counters with the unaccounted residue called out. This is the gate
instrument for the replication byte-economy work ("5-10× fewer bytes" must
show up HERE, not in a hand-picked counter).

``--job`` slices fleet-scope inputs back to one job post-hoc: on an events
JSONL it keeps only records stamped with that job identity
($TPU_RESILIENCY_JOB, set by launchers under ``--fleet-dir``); the input may
also be a metrics *snapshot* document (``MetricsRegistry.snapshot`` format —
e.g. the ``metrics`` section of a ``tpu-fleetd`` snapshot), in which case the
series carrying the matching ``job=`` label are kept (the ``fleet:*``
cross-job totals, which belong to no single job, are dropped from the slice).
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from typing import Optional

from tpu_resiliency_torch.tools import SIGPIPE_EXIT, pipe_safe
from tpu_resiliency_torch.utils.events import read_events
from tpu_resiliency_torch.utils.metrics import MetricsRegistry, aggregate


def _counter_total(reg: MetricsRegistry, name: str) -> float:
    snap = reg.snapshot()["metrics"].get(name, [])
    return sum(e.get("value", 0.0) for e in snap)


def load_snapshot_doc(path: str) -> Optional[dict]:
    """Parse ``path`` as a metrics snapshot document, or None when it is not
    one (an events JSONL line also parses as a dict — only a whole-file JSON
    object with a ``metrics`` dict is a snapshot)."""
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError, UnicodeDecodeError):
        return None
    if isinstance(doc, dict) and isinstance(doc.get("metrics"), dict):
        return doc
    return None


def slice_snapshot_job(doc: dict, job: str) -> dict:
    """One job's slice of a fleet-merged snapshot: series whose ``job`` label
    matches, with the label dropped (the slice IS that job's view — keeping
    it would make the slice unmergeable with the job's own snapshots);
    ``fleet:*`` totals and other-job series are excluded."""
    out: dict = {"ts": doc.get("ts"), "metrics": {}}
    for name, entries in (doc.get("metrics") or {}).items():
        if name.startswith("fleet:") or not isinstance(entries, list):
            continue
        kept = []
        for e in entries:
            if not isinstance(e, dict):
                continue
            labels = dict(e.get("labels") or {})
            if labels.pop("job", None) != job:
                continue
            kept.append({**e, "labels": labels})
        if kept:
            out["metrics"][name] = kept
    return out


def _fmt_s(v: float) -> str:
    if math.isnan(v):
        return "-"
    return f"{v * 1e3:.1f} ms" if v < 1.0 else f"{v:.2f} s"


def _latency_lines(reg: MetricsRegistry, family: str, label: str) -> list[str]:
    """p50/p95 per labelled series of one histogram family, stably ordered."""
    out = []
    for labels, h in sorted(reg.histograms(family).items()):
        name = dict(labels).get(label, "?")
        out.append(
            f"    {name}: n={h.count} p50={_fmt_s(h.quantile(0.5))} "
            f"p95={_fmt_s(h.quantile(0.95))} max={_fmt_s(h.quantile(1.0))}"
        )
    return out


def render_report(reg: MetricsRegistry, out=None) -> None:
    """The operator summary: restarts, rendezvous latency, checkpoint latency."""
    out = sys.stdout if out is None else out
    snap = reg.snapshot()["metrics"]

    total = _counter_total(reg, "tpu_events_total")
    print(f"events: {int(total)}", file=out)

    print("restarts:", file=out)
    restarts = {
        dict(e["labels"]).get("layer", "?"): e["value"]
        for e in snap.get("tpu_restarts_total", [])
    }
    print(f"    in-job requested: {int(restarts.get('injob', 0))}", file=out)
    print(f"    in-process signalled: {int(restarts.get('inprocess', 0))}", file=out)
    for name, label in (
        ("tpu_rendezvous_rounds_total", "rendezvous rounds"),
        ("tpu_worker_failures_total", "worker failures"),
        ("tpu_rank_terminations_total", "rank terminations"),
        ("tpu_budget_exhausted_total", "budget exhaustions"),
        ("tpu_ckpt_saves_total", "checkpoint saves"),
        ("tpu_ckpt_save_failures_total", "checkpoint save failures"),
    ):
        n = _counter_total(reg, name)
        if n:
            print(f"    {label}: {int(n)}", file=out)
    # Labelled restart-machinery rows: warm-spare promotion attempts by
    # outcome (worker_promoted events), fast-path rendezvous, compile cache.
    for name, label in (
        ("tpu_spare_promotions_total", "warm-spare promotions"),
        ("tpu_rendezvous_fast_path_total", "fast-path rendezvous"),
        ("tpu_compile_cache_total", "compile cache"),
    ):
        by_outcome = {
            dict(e["labels"]).get("outcome", "?"): e["value"]
            for e in snap.get(name, [])
        }
        if by_outcome:
            detail = " ".join(
                f"{k}={int(v)}" for k, v in sorted(by_outcome.items())
            )
            print(f"    {label}: {detail}", file=out)

    # Autoscale controller: decisions by action/outcome + forecast accuracy.
    decisions = snap.get("tpu_autoscale_decisions_total", [])
    if decisions:
        rows = sorted(
            (dict(e["labels"]).get("action", "?"),
             dict(e["labels"]).get("outcome", "?"), e["value"])
            for e in decisions
        )
        detail = " ".join(f"{a}/{o}={int(v)}" for a, o, v in rows)
        print(f"autoscale decisions: {detail}", file=out)
        for labels, h in sorted(
            reg.histograms("tpu_autoscale_predicted_vs_realized").items()
        ):
            if not h.count:
                continue
            action = dict(labels).get("action", "?")
            print(
                f"    forecast error ({action}): n={h.count} "
                f"mean={h.sum / h.count:+.3f}s "
                f"p95={h.quantile(0.95):+.3f}s",
                file=out,
            )
    rescinds = _counter_total(reg, "tpu_preemption_rescinded_total")
    if rescinds:
        print(f"    preemption notices rescinded: {int(rescinds)}", file=out)

    span_lines = _latency_lines(reg, "tpu_span_seconds", "span")
    if span_lines:
        print("span durations (p50/p95):", file=out)
        for line in span_lines:
            print(line, file=out)
    timing_lines = _latency_lines(reg, "tpu_timing_seconds", "name")
    if timing_lines:
        print("timed blocks (p50/p95):", file=out)
        for line in timing_lines:
            print(line, file=out)

    # Step timing (tpu_step_seconds: consecutive iteration_start deltas).
    step_hists = reg.histograms("tpu_step_seconds")
    if step_hists:
        h = next(iter(step_hists.values()))
        if h.count:
            print(
                f"training steps: n={h.count} p50={_fmt_s(h.quantile(0.5))} "
                f"p95={_fmt_s(h.quantile(0.95))}",
                file=out,
            )

    # The two headline latencies, called out by name so a fleet dashboard's
    # first question needs no knowledge of span naming conventions.
    rdzv = reg.histograms("tpu_span_seconds").get((("span", "rendezvous.round"),))
    if rdzv is not None and rdzv.count:
        print(
            f"rendezvous round duration: n={rdzv.count} "
            f"p50={_fmt_s(rdzv.quantile(0.5))} p95={_fmt_s(rdzv.quantile(0.95))}",
            file=out,
        )
    ckpt = [
        (dict(labels)["name"], h)
        for labels, h in reg.histograms("tpu_timing_seconds").items()
        if dict(labels).get("name", "").startswith("ckpt.") and h.count
    ]
    if ckpt:
        worst = {name: h.quantile(0.95) for name, h in ckpt}
        total_p50 = sum(h.quantile(0.5) for _, h in ckpt)
        print(
            f"checkpoint save/load latency: phases={sorted(worst)} "
            f"sum(p50)={_fmt_s(total_p50)}",
            file=out,
        )


def main(argv: Optional[list[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="Aggregate a tpu-resiliency events JSONL file into metrics"
    )
    ap.add_argument("events_file")
    ap.add_argument(
        "--format", choices=("report", "prom", "json"), default="report",
        help="report: human summary (default); prom: Prometheus text "
        "exposition; json: quantile snapshot",
    )
    ap.add_argument(
        "-o", "--output", default=None,
        help="write here instead of stdout (json format: atomic write)",
    )
    ap.add_argument(
        "--goodput", action="store_true",
        help="render the time-attribution ledger (train/ckpt_stall/restart/"
        "incident/unattributed + goodput ratio) instead of the metrics "
        "report; --format json emits the same attribution document the "
        "launcher's live /goodput endpoint serves",
    )
    ap.add_argument(
        "--baseline", default=None,
        help="with --goodput: a second events JSONL to compare against — "
        "renders per-phase deltas and the goodput-ratio delta (this run "
        "minus the baseline), the arithmetic the autoscale chaos scenario "
        "gates on",
    )
    ap.add_argument(
        "--bytes", action="store_true", dest="bytes_flow",
        help="render the byte-flow ledger (bytes attributed to purpose/"
        "direction/peer, reconciled against the per-family byte counters "
        "with the residue called out) instead of the metrics report; "
        "--format json emits the tpu-byteflow-1 document",
    )
    ap.add_argument(
        "--job", default=None,
        help="slice a fleet-scope input back to one job: on an events JSONL, "
        "keep only records stamped with this job identity (launcher "
        "--fleet-dir); on a metrics snapshot document, keep only series "
        "carrying the matching job= label (fleet:* totals dropped)",
    )
    args = ap.parse_args(argv)
    if args.baseline and not args.goodput:
        print("--baseline requires --goodput", file=sys.stderr)
        return 2
    if args.bytes_flow and (args.goodput or args.baseline):
        print("--bytes and --goodput are mutually exclusive", file=sys.stderr)
        return 2
    try:
        with open(args.events_file):
            pass
    except OSError as e:
        print(f"cannot read events file: {e}", file=sys.stderr)
        return 1
    snapshot_doc = load_snapshot_doc(args.events_file) if args.job else None
    if snapshot_doc is not None:
        if args.goodput or args.bytes_flow:
            print(
                "--goodput/--bytes need an events stream, not a metrics "
                "snapshot",
                file=sys.stderr,
            )
            return 2
        reg = MetricsRegistry()
        try:
            reg.merge(slice_snapshot_job(snapshot_doc, args.job))
        except (ValueError, TypeError) as e:
            print(f"cannot slice snapshot: {e}", file=sys.stderr)
            return 1
        return _emit_registry(reg, args)
    records = read_events(args.events_file)
    if args.job is not None:
        records = [r for r in records if r.get("job") == args.job]
        if not records:
            print(f"no events for job {args.job!r}", file=sys.stderr)
            return 1
    if not records:
        print("no events to aggregate", file=sys.stderr)
        return 1
    if args.bytes_flow:
        from tpu_resiliency_torch.utils.byteflow import ByteFlowLedger, render_table

        ledger = ByteFlowLedger()
        ledger.observe_many(records)
        summary = ledger.summary()
        # Belt and suspenders: the same stream through the independent
        # counter mapping — any drift names an emitter one side misreads.
        recon = ledger.reconcile(aggregate(records))

        def emit_bytes() -> None:
            if args.format == "json":
                json.dump({**summary, "reconcile": recon}, sys.stdout, indent=2)
                sys.stdout.write("\n")
            else:
                render_table(summary, reconcile=recon)

        if args.output:
            with open(args.output, "w") as f:
                old, sys.stdout = sys.stdout, f
                try:
                    emit_bytes()
                finally:
                    sys.stdout = old
            print(f"wrote {args.output}")
            return 0
        if pipe_safe(emit_bytes):
            return SIGPIPE_EXIT
        return 0
    if args.goodput:
        from tpu_resiliency_torch.utils.goodput import (
            GoodputLedger,
            compare,
            render_compare,
            render_table,
        )

        ledger = GoodputLedger()
        ledger.observe_many(records)
        summary = ledger.summary()
        comparison = None
        if args.baseline:
            try:
                base_records = read_events(args.baseline)
            except OSError as e:
                print(f"cannot read baseline events file: {e}", file=sys.stderr)
                return 1
            if not base_records:
                print("no baseline events to aggregate", file=sys.stderr)
                return 1
            base = GoodputLedger()
            base.observe_many(base_records)
            comparison = compare(summary, base.summary())

        def emit_goodput() -> None:
            if args.format == "json":
                json.dump(
                    comparison if comparison is not None else summary,
                    sys.stdout, indent=2,
                )
                sys.stdout.write("\n")
            elif comparison is not None:
                render_compare(comparison)
            else:
                render_table(summary)

        if args.output:
            with open(args.output, "w") as f:
                old, sys.stdout = sys.stdout, f
                try:
                    emit_goodput()
                finally:
                    sys.stdout = old
            print(f"wrote {args.output}")
            return 0
        if pipe_safe(emit_goodput):
            return SIGPIPE_EXIT
        return 0
    return _emit_registry(aggregate(records), args)


def _emit_registry(reg: MetricsRegistry, args) -> int:
    """Render a built registry per --format/--output (the shared tail of the
    events-aggregation and snapshot-slice paths)."""
    if args.format == "json" and args.output:
        reg.write_json(args.output)
        print(f"wrote {args.output}")
        return 0

    def emit() -> None:
        if args.format == "prom":
            sys.stdout.write(reg.to_prometheus())
        elif args.format == "json":
            json.dump(reg.snapshot(), sys.stdout, indent=2, default=repr)
            sys.stdout.write("\n")
        else:
            render_report(reg)

    if args.output:
        with open(args.output, "w") as f:
            old, sys.stdout = sys.stdout, f
            try:
                emit()
            finally:
                sys.stdout = old
        print(f"wrote {args.output}")
        return 0
    if pipe_safe(emit):
        return SIGPIPE_EXIT
    return 0


if __name__ == "__main__":
    sys.exit(main())
