"""Human timeline over the structured event stream.

The framework narrates every resiliency decision to a JSONL stream
(``$TPU_RESILIENCY_EVENTS_FILE``, ``utils/events.py``): rendezvous rounds,
worker failures and warm-spare promotions, in-process restart iterations,
straggler reports, preemption sync points, FT milestones. This tool is the
consumer side — it renders one run's stream as a timeline plus a summary, the
post-mortem view the reference leaves to ad-hoc log grepping (its torchelastic
events/metrics streams have no bundled reader; its tests grep log lines,
``tests/straggler/func/check_log.py``).

Usage::

    python -m tpu_resiliency_torch.tools.events_summary run_events.jsonl
    python -m tpu_resiliency_torch.tools.events_summary run_events.jsonl --kind worker_failed
    # comma-separated kinds compose with the time/trace slicers; the footer
    # counts the filtered slice
    python -m tpu_resiliency_torch.tools.events_summary ev.jsonl --kind hang_detected,kill_ladder,stack_dump
    python -m tpu_resiliency_torch.tools.events_summary run_events.jsonl --no-timeline
    python -m tpu_resiliency_torch.tools.events_summary run_events.jsonl --follow
    # slice to one incident: absolute epoch, ISO-8601, or stream-relative +SECS
    python -m tpu_resiliency_torch.tools.events_summary ev.jsonl --since +42 --until +97
    python -m tpu_resiliency_torch.tools.events_summary ev.jsonl --trace 4f2a91b0c3d4e5f6
    # slice a fleet-shared stream back to one job (launcher --fleet-dir stamps
    # the job identity onto every record)
    python -m tpu_resiliency_torch.tools.events_summary ev.jsonl --job trainer-a
"""

from __future__ import annotations

import argparse
import os
import sys
from collections import Counter
from typing import Any, Optional

from tpu_resiliency_torch.tools import SIGPIPE_EXIT, pipe_safe
from tpu_resiliency_torch.utils.events import RESERVED_KEYS, read_events


def _payload(rec: dict) -> dict:
    return {k: v for k, v in rec.items() if k not in RESERVED_KEYS}


def parse_when(spec: str) -> tuple[float, bool]:
    """One ``--since``/``--until`` operand → ``(seconds, relative)``.

    Three spellings, matched to how operators actually hold timestamps:
    raw epoch seconds (what the JSONL carries), ISO-8601 (what an incident
    report or pager shows — naive stamps are LOCAL time, matching
    ``datetime.fromtimestamp`` output), and ``+SECS`` relative to the stream's
    first event (what the timeline itself prints as ``t+...s``)."""
    spec = spec.strip()
    if spec.startswith("+"):
        return float(spec[1:]), True
    try:
        return float(spec), False
    except ValueError:
        pass
    import datetime

    try:
        dt = datetime.datetime.fromisoformat(spec)
    except ValueError:
        raise ValueError(
            f"cannot parse time {spec!r}: want epoch seconds, ISO-8601, "
            f"or +SECS relative to stream start"
        ) from None
    return dt.timestamp(), False


def parse_kinds(spec: Optional[str]) -> Optional[frozenset]:
    """``--kind`` operand → kind set (comma-separated; None/empty → None)."""
    if spec is None:
        return None
    kinds = frozenset(k.strip() for k in spec.split(",") if k.strip())
    return kinds or None


def make_filter(
    since: Optional[str], until: Optional[str], trace: Optional[str], t0: float,
    kinds: Optional[frozenset] = None, job: Optional[str] = None,
):
    """Record predicate for the --since/--until/--trace/--kind/--job slicers;
    ``t0`` resolves relative (+SECS) bounds. The kind set composes with the
    time/trace bounds, so timeline AND footer reflect one slice. ``job``
    matches the envelope's fleet job identity ($TPU_RESILIENCY_JOB, stamped
    by launchers running under --fleet-dir) — the slicer that takes a stream
    several jobs share back to one job."""
    lo = hi = None
    if since is not None:
        s, rel = parse_when(since)
        lo = t0 + s if rel else s
    if until is not None:
        s, rel = parse_when(until)
        hi = t0 + s if rel else s

    def keep(rec: dict) -> bool:
        ts = rec.get("ts")
        if lo is not None and (not isinstance(ts, (int, float)) or ts < lo):
            return False
        if hi is not None and (not isinstance(ts, (int, float)) or ts > hi):
            return False
        if trace is not None and rec.get("trace_id") != trace:
            return False
        if job is not None and rec.get("job") != job:
            return False
        if kinds is not None and rec.get("kind") not in kinds:
            return False
        return True

    return keep


def _fmt_default(p: dict) -> str:
    return " ".join(f"{k}={v}" for k, v in p.items())


def _fmt_rendezvous_round(p: dict) -> str:
    spares = f" spares={p['spares']}" if p.get("spares") else ""
    return (
        f"round {p.get('round')}: world={p.get('world_size')} "
        f"active={p.get('active')}{spares}"
    )


def _fmt_worker_failed(p: dict) -> str:
    return f"rank {p.get('global_rank')} failed: {p.get('detail', p.get('exitcode'))}"


def _fmt_worker_promoted(p: dict) -> str:
    outcome = p.get("outcome", "promoted")
    if outcome == "dead_at_promotion":
        return (
            f"warm spare DIED at promotion -> rank {p.get('global_rank')} "
            f"cold-spawned (round {p.get('round')})"
        )
    if outcome == "cold_fallback":
        return (
            f"no warm spare -> rank {p.get('global_rank')} cold-spawned "
            f"(round {p.get('round')})"
        )
    depth = f", depth {p['park_depth']}" if p.get("park_depth") else ""
    return (
        f"warm spare promoted -> rank {p.get('global_rank')} "
        f"(round {p.get('round')}, pid {p.get('worker_pid')}{depth})"
    )


def _fmt_straggler_report(p: dict) -> str:
    flagged = p.get("stragglers_by_perf") or []
    by_sec = p.get("stragglers_by_section") or {}
    if not flagged and not by_sec:
        return f"step {p.get('step')}: clean ({len(p.get('perf_scores') or {})} ranks)"
    parts = []
    if flagged:
        parts.append(f"by perf {flagged}")
    if by_sec:
        parts.append(f"by section {by_sec}")
    return f"step {p.get('step')}: STRAGGLERS " + ", ".join(parts)


def _fmt_restart_signalled(p: dict) -> str:
    return (
        f"iteration {p.get('iteration')} restarting "
        f"(initial_rank {p.get('initial_rank')})"
    )


def _fmt_delta(v) -> str:
    return f"{v:+.3f}s" if isinstance(v, (int, float)) else "?"


def _fmt_autoscale_decision(p: dict) -> str:
    victims = p.get("victims") or []
    target = f" ranks {victims}" if victims else ""
    return (
        f"#{p.get('decision_id')} {p.get('action')}{target}: predicted "
        f"{_fmt_delta(p.get('predicted_delta_s'))} "
        f"[{p.get('mode')}/{p.get('outcome')}] — {p.get('reason', '')}"
    )


def _fmt_autoscale_outcome(p: dict) -> str:
    return (
        f"#{p.get('decision_id')} {p.get('action')}: predicted "
        f"{_fmt_delta(p.get('predicted_delta_s'))} realized "
        f"{_fmt_delta(p.get('realized_delta_s'))} (error "
        f"{_fmt_delta(p.get('forecast_error_s'))})"
    )


def _fmt_preemption_rescinded(p: dict) -> str:
    return (
        f"notice from step {p.get('noticed_step')} withdrawn at step "
        f"{p.get('step')}; deferred drain/save cancelled"
    )


def _fmt_alert_fired(p: dict) -> str:
    detail = p.get("detail")
    return (
        f"rule={p.get('rule')} sev={p.get('severity')} FIRING"
        + (f": {detail}" if detail else "")
    )


def _fmt_alert_resolved(p: dict) -> str:
    dur = p.get("duration_s")
    held = f" for {dur:g}s" if isinstance(dur, (int, float)) else ""
    detail = p.get("detail")
    return (
        f"rule={p.get('rule')} sev={p.get('severity')} resolved{held}"
        + (f": {detail}" if detail else "")
    )


def _fmt_store_failover(p: dict) -> str:
    ep = p.get("endpoint")
    return (
        f"shard {p.get('shard')}{f' ({ep})' if ep else ''} {p.get('op')}: "
        f"{p.get('outcome')} → successor shard {p.get('successor')}"
    )


def _fmt_shard_epoch(p: dict) -> str:
    mig = p.get("migrated")
    return (
        f"epoch {p.get('epoch')} ({p.get('nshards')} shards): "
        f"{p.get('outcome')}"
        + (f", {mig} keys migrated" if isinstance(mig, int) else "")
    )


_FORMATTERS = {
    "rendezvous_round": _fmt_rendezvous_round,
    "worker_failed": _fmt_worker_failed,
    "worker_promoted": _fmt_worker_promoted,
    "straggler_report": _fmt_straggler_report,
    "restart_signalled": _fmt_restart_signalled,
    "autoscale_decision": _fmt_autoscale_decision,
    "autoscale_outcome": _fmt_autoscale_outcome,
    "preemption_rescinded": _fmt_preemption_rescinded,
    "alert_fired": _fmt_alert_fired,
    "alert_resolved": _fmt_alert_resolved,
    "store_failover": _fmt_store_failover,
    "shard_epoch": _fmt_shard_epoch,
}

#: Kinds counted in the footer under friendlier names.
_SUMMARY_LINES = (
    ("rendezvous_round", "rendezvous rounds"),
    ("worker_failed", "worker failures"),
    ("worker_promoted", "warm-spare promotions"),
    ("restart_requested", "in-job restart requests"),
    ("restart_signalled", "in-process restarts"),
    ("fn_exception", "in-process fn exceptions"),
    ("rank_terminated", "ranks terminated"),
    ("straggler_report", "straggler reports"),
    ("degraded_set", "degraded-set updates"),
    ("preemption_sync_point", "preemption sync points"),
    ("preemption_rescinded", "preemption notices rescinded"),
    ("autoscale_decision", "autoscale decisions"),
    ("alert_fired", "watchtower alerts fired"),
    ("alert_resolved", "watchtower alerts resolved"),
    ("store_failover", "store shard failovers"),
    ("shard_epoch", "store shard-map epoch transitions"),
    ("timeouts_calculated", "FT timeout calibrations"),
    ("training_finished", "training finished"),
    ("budget_exhausted", "restart budget exhausted"),
)


def summarize(
    records: list[dict[str, Any]],
    out=None,
    kind: Optional[str] = None,
    timeline: bool = True,
    keep=None,
) -> None:
    """``keep``: optional record predicate (the --since/--until/--trace slice).
    ``kind``: comma-separated kind filter, part of the same slice — timeline
    AND footer reflect it (counting kinds the filter excluded would make the
    footer disagree with the timeline it summarizes). Sliced records drive
    both, but ``t+`` offsets stay anchored to the FULL stream's first event,
    so a sliced view's timestamps line up with the unsliced one."""
    out = sys.stdout if out is None else out  # resolved at call time, not import
    records = [r for r in records if "ts" in r and "kind" in r]
    if not records:
        print("no events", file=out)
        return
    records.sort(key=lambda r: r["ts"])
    t0 = records[0]["ts"]
    kinds = parse_kinds(kind)
    if keep is not None or kinds is not None:
        records = [
            r for r in records
            if (keep is None or keep(r)) and (kinds is None or r["kind"] in kinds)
        ]
        if not records:
            print("no events in the selected slice", file=out)
            return
    if timeline:
        for r in records:
            print(format_line(r, t0), file=out)
    _footer(
        Counter(r["kind"] for r in records),
        n_events=len(records),
        n_pids=len({r.get("pid") for r in records}),
        span=records[-1]["ts"] - t0,
        out=out,
    )


def _footer(counts: Counter, n_events: int, n_pids: int, span: float, out) -> None:
    print(
        f"\n{n_events} events over {span:.1f}s from {n_pids} processes",
        file=out,
    )
    for k, label in _SUMMARY_LINES:
        if counts.get(k):
            print(f"  {label}: {counts[k]}", file=out)
    leftover = {
        k: n for k, n in counts.items() if k not in {k for k, _ in _SUMMARY_LINES}
    }
    if leftover:
        print(f"  other: {dict(sorted(leftover.items()))}", file=out)


def format_line(rec: dict, t0: float) -> str:
    """One timeline line (shared by the batch and --follow paths)."""
    p = _payload(rec)
    line = _FORMATTERS.get(rec["kind"], _fmt_default)(p)
    rank = f" r{rec['rank']}" if rec.get("rank") is not None else ""
    return (
        f"t+{rec['ts'] - t0:9.3f}s [{rec.get('source', '?')}{rank}] "
        f"{rec['kind']}: {line}"
    )


def iter_new_records(path: str, poll: float = 0.5, stop=None):
    """Yield records as writers append them (tail -f over the JSONL stream).

    Binary-mode reads with byte offsets (a character-count offset would
    corrupt the resume position on multi-byte content from non-framework
    producers); torn trailing lines are retried whole on the next poll
    (JSONL writes are single atomic appends, so a partial line only means we
    raced the writer mid-write). Replacement detection is ``tail -F``:
    the file's identity (``st_ino``/``st_dev``) is tracked alongside its
    size, so a recreated events file from a NEW launcher run restarts the
    offset at zero even when the new file has already grown past the old
    offset by the next poll — size-shrink alone would resume mid-file at an
    arbitrary byte. A missing file is the wait state — the launcher may not
    have started — but any other OSError (directory, permission)
    propagates: an unrecoverable path must fail visibly, not hang silently.
    ``stop``: optional ``threading.Event``-like; checked each poll so tests
    (and signal handlers) can end the loop."""
    import json
    import time as _time

    offset = 0
    buf = b""
    file_id = None  # (st_ino, st_dev) of the file the offset belongs to
    while stop is None or not stop.is_set():
        try:
            with open(path, "rb") as f:
                st = os.fstat(f.fileno())
                if file_id is not None and (st.st_ino, st.st_dev) != file_id:
                    # Recreated under the same name (a new launcher run):
                    # the old offset describes a different file entirely.
                    offset = 0
                    buf = b""
                file_id = (st.st_ino, st.st_dev)
                if f.seek(0, 2) < offset:
                    # Truncated in place: restart from the top like tail -f
                    # on shrink.
                    offset = 0
                    buf = b""
                f.seek(offset)
                chunk = f.read()
        except FileNotFoundError:
            chunk = b""
        if chunk:
            offset += len(chunk)
            buf += chunk
            while b"\n" in buf:
                line, buf = buf.split(b"\n", 1)
                if not line.strip():
                    continue
                try:
                    yield json.loads(line.decode("utf-8"))
                except (json.JSONDecodeError, UnicodeDecodeError):
                    continue
        else:
            _time.sleep(poll)


class _StdoutGone:
    """Stop-condition for --follow: fires when stdout's consumer disappears.

    A follower writing into a dead pipe exits via EPIPE on its next print —
    but a follower that is IDLE (quiet stream) never writes again and would
    linger forever after ``| head`` exits. Polling the stdout fd for
    POLLERR/POLLHUP catches the closed pipe without writing; on a terminal
    the poll simply never fires."""

    def __init__(self) -> None:
        import select

        self._poll = None
        try:
            fd = sys.stdout.fileno()
        except Exception:
            # Wrapped/captured stdout (pytest, io wrappers) has no fd: no
            # consumer-death detection, but the follower must still run.
            return
        self._poll = select.poll()
        self._poll.register(fd, select.POLLERR | select.POLLHUP)

    def is_set(self) -> bool:
        if self._poll is None:
            return False
        try:
            return bool(self._poll.poll(0))
        except OSError:
            return True


def _follow(
    path: str,
    kind: Optional[str],
    since: Optional[str] = None,
    until: Optional[str] = None,
    trace: Optional[str] = None,
    job: Optional[str] = None,
) -> int:
    # Incremental footer state, not a record list: a multi-day follow on a
    # chatty job must not grow RSS one dict per event.
    counts: Counter = Counter()
    pids: set = set()
    t0: Optional[float] = None
    last_ts = 0.0
    keep = None  # built once t0 is known (relative bounds need it)
    kinds = parse_kinds(kind)

    def emit() -> None:
        nonlocal t0, last_ts, keep
        try:
            for rec in iter_new_records(path, stop=_StdoutGone()):
                if "ts" not in rec or "kind" not in rec:
                    continue
                if t0 is None:
                    t0 = rec["ts"]
                    keep = make_filter(
                        since, until, trace, t0, kinds=kinds, job=job
                    )
                if not keep(rec):
                    continue
                counts[rec["kind"]] += 1
                pids.add(rec.get("pid"))
                last_ts = max(last_ts, rec["ts"])
                print(format_line(rec, t0), flush=True)
        except KeyboardInterrupt:
            pass
        if counts:
            _footer(
                counts,
                n_events=sum(counts.values()),
                n_pids=len(pids),
                span=last_ts - (t0 or last_ts),
                out=sys.stdout,
            )

    try:
        # `--follow | head` must exit clean like batch mode — but as 141, so a
        # script can tell the follow was cut short rather than complete.
        if pipe_safe(emit):
            return SIGPIPE_EXIT
    except OSError as e:
        print(f"cannot follow events file: {e}", file=sys.stderr)
        return 1
    return 0


def main(argv: Optional[list[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="Render a tpu-resiliency structured event stream as a timeline"
    )
    ap.add_argument("events_file")
    ap.add_argument(
        "--kind",
        help="show only these event kinds (comma-separated); composes with "
        "--since/--until/--trace, and the footer counts the filtered slice",
    )
    ap.add_argument(
        "--since",
        help="drop records before this time: epoch seconds, ISO-8601, or "
        "+SECS relative to the stream's first event (matches the timeline's "
        "t+ offsets) — slice the stream to one incident without grep",
    )
    ap.add_argument(
        "--until",
        help="drop records after this time (same formats as --since)",
    )
    ap.add_argument(
        "--trace",
        help="show only records carrying this trace id (one run on a stream "
        "shared by several)",
    )
    ap.add_argument(
        "--job",
        help="show only records stamped with this fleet job identity "
        "($TPU_RESILIENCY_JOB, the launcher's --rdzv-id under --fleet-dir) — "
        "slice a fleet-merged stream back to one job post-hoc; composes with "
        "the other slicers",
    )
    ap.add_argument(
        "--no-timeline", action="store_true", help="print only the summary footer"
    )
    ap.add_argument(
        "--follow",
        action="store_true",
        help="tail the stream live (Ctrl-C prints the summary); the file may "
        "not exist yet — a launcher that hasn't started still gets watched",
    )
    args = ap.parse_args(argv)
    try:
        # Validate the time specs up front — a typo'd --since must fail the
        # invocation, not silently show the whole stream.
        for spec in (args.since, args.until):
            if spec is not None:
                parse_when(spec)
    except ValueError as e:
        print(str(e), file=sys.stderr)
        return 2
    if args.follow:
        return _follow(
            args.events_file, args.kind,
            since=args.since, until=args.until, trace=args.trace, job=args.job,
        )
    # read_events tolerates unreadable files (shared-stream readers race the
    # first writer); a CLI invocation on a missing/denied/directory path must
    # fail visibly, not report an empty-but-successful run.
    try:
        with open(args.events_file):
            pass
    except OSError as e:
        print(f"cannot read events file: {e}", file=sys.stderr)
        return 1
    records = read_events(args.events_file)
    keep = None
    if args.since or args.until or args.trace or args.job:
        tss = [r["ts"] for r in records if isinstance(r.get("ts"), (int, float))]
        keep = make_filter(
            args.since, args.until, args.trace, min(tss) if tss else 0.0,
            job=args.job,
        )
    if pipe_safe(
        lambda: summarize(
            records, kind=args.kind, timeline=not args.no_timeline, keep=keep
        )
    ):
        return SIGPIPE_EXIT
    return 0


if __name__ == "__main__":
    sys.exit(main())
