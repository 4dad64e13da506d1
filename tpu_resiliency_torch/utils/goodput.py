"""Goodput ledger: attribute a job's wall clock to what it was actually doing.

Six PRs of telemetry record every rendezvous, restart, checkpoint stall, and
incident — but none of it answers the operator's first question: *what
fraction of the last hour was training?* This module closes that gap. Driven
by the same structured event stream everything else consumes (live tail or a
finished JSONL), a :class:`GoodputLedger` classifies the job's wall clock
into phases:

- ``train`` — the deltas between a rank's consecutive ``iteration_start``
  markers (strictly-consecutive iterations only, capped at
  :data:`~tpu_resiliency_torch.utils.metrics.STEP_GAP_MAX_S` — a gap is downtime,
  not a long step);
- ``ckpt_stall`` — the caller-visible checkpoint windows:
  ``ckpt_foreground_blocked`` records, the ``ckpt.save.enqueue`` span, and
  the blocking save/load timings (``ckpt.save.*``, ``ckpt.load``,
  ``ckpt.local_load``);
- ``restart`` — the window from the first fault evidence (``worker_failed``,
  ``hang_detected``, ``restart_requested``, ...) to the next
  ``iteration_start`` (training actually resumed — detection, teardown,
  re-rendezvous, respawn, and the respawned interpreter's imports are all
  restart cost), plus the machinery's instrumented spans (``worker.spawn``,
  ``rendezvous.round``, ``inprocess.restart``) for segments outside any
  fault window;
- ``incident`` — open→close windows from the incident engine
  (``launcher/incident.py``); an incident still open at end-of-stream is
  charged through to the last observed timestamp;
- ``unattributed`` — the residue. A healthy training job keeps this small;
  a large residue is itself a finding (time the instrumentation cannot
  explain).

Attribution is **interval-based**, not duration-summed: each phase's raw
windows are merged into intervals on the job's wall-clock timeline and
higher-severity phases own overlaps (incident > restart > ckpt_stall >
train). Overlapping evidence — a sync save that emits both a foreground
record and its per-phase timings, or two ranks stalling simultaneously —
therefore never double-counts, and the five phases sum to the job's wall
clock *exactly*.

Surfaces:

- :meth:`GoodputLedger.summary` — the attribution document served by the
  launcher's ``/goodput`` endpoint and rendered by
  ``tpu-metrics-dump --goodput``;
- :meth:`GoodputLedger.publish` — routes per-phase attribution deltas
  through the event stream as ``goodput_update`` records, which
  ``observe_record`` maps to ``tpu_time_attributed_seconds_total{phase}``
  and ``tpu_goodput_ratio`` — so the live Prometheus view and a post-hoc
  ``aggregate()`` of the same stream agree.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, Optional

from tpu_resiliency_torch.utils import events as events_mod
from tpu_resiliency_torch.utils.metrics import step_gap_max_s

SCHEMA = "tpu-goodput-1"

#: attribution priority, highest first: a second claimed by two phases goes
#: to the more severe one (an incident's restart churn is incident time).
PHASES = ("incident", "restart", "ckpt_stall", "train")

#: spans whose duration is restart machinery (spawn, re-rendezvous, the
#: in-process restart sequence). The initial round's rendezvous/spawn counts
#: too: time-to-first-step is not goodput either.
RESTART_SPANS = frozenset({"worker.spawn", "rendezvous.round", "inprocess.restart"})

#: fault evidence that opens a restart window. The spans above cover the
#: machinery's instrumented segments, but most of a restart's wall-clock cost
#: sits BETWEEN them (failure detection, worker teardown, respawned-process
#: import). The window from the first fault evidence to the next
#: ``iteration_start`` (training actually resumed) is the restart cost an
#: operator experiences — that whole span is charged to ``restart``.
RESTART_EVIDENCE = frozenset({
    "failure_detected", "worker_failed", "restart_requested",
    "restart_signalled", "hang_detected", "health_terminated",
    "rank_terminated",
})

#: spans whose duration is a caller-visible checkpoint stall
CKPT_STALL_SPANS = frozenset({"ckpt.save.enqueue"})

#: blocking checkpoint timings. ``ckpt.save.write`` is foreground for sync
#: saves; a pipelined save's background mirror writes also carry the name —
#: charging those overlaps to ckpt_stall is the conservative direction for a
#: goodput SLO (never over-reports training time).
CKPT_STALL_TIMINGS = frozenset({
    "ckpt.save.d2h", "ckpt.save.serialize", "ckpt.save.replicate",
    "ckpt.save.write", "ckpt.async_save", "ckpt.load", "ckpt.local_load",
})


# -- interval algebra ---------------------------------------------------------


def merge_intervals(ivs: Iterable[tuple[float, float]]) -> list[tuple[float, float]]:
    """Union of half-open intervals, sorted and coalesced."""
    out: list[tuple[float, float]] = []
    for s, e in sorted((s, e) for s, e in ivs if e > s):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def subtract_intervals(
    a: list[tuple[float, float]], b: list[tuple[float, float]]
) -> list[tuple[float, float]]:
    """``a`` minus the union ``b``; both inputs must be merged/sorted."""
    out: list[tuple[float, float]] = []
    j = 0
    for s, e in a:
        cur = s
        while j < len(b) and b[j][1] <= cur:
            j += 1
        k = j
        while k < len(b) and b[k][0] < e:
            bs, be = b[k]
            if bs > cur:
                out.append((cur, bs))
            cur = max(cur, be)
            if be >= e:
                break
            k += 1
        if cur < e:
            out.append((cur, e))
    return out


def total_seconds(ivs: Iterable[tuple[float, float]]) -> float:
    return sum(e - s for s, e in ivs)


def _clip(
    ivs: Iterable[tuple[float, float]], lo: float, hi: float
) -> list[tuple[float, float]]:
    return [(max(s, lo), min(e, hi)) for s, e in ivs if min(e, hi) > max(s, lo)]


# -- the ledger ---------------------------------------------------------------


class GoodputLedger:
    """Streamed time attribution over event records (flat JSONL dict shape).

    Feed with :meth:`observe` (one record) or :meth:`observe_many`; read with
    :meth:`summary`. The ledger is cheap per record — interval merging and
    priority subtraction happen at summary time, not per event.
    """

    def __init__(self, *, max_step_s: Optional[float] = None):
        # Resolved at construction (not import) so $TPU_RESILIENCY_STEP_GAP_MAX
        # set by the launcher reaches every ledger built after it.
        self.max_step_s = step_gap_max_s() if max_step_s is None else max_step_s
        self._min_ts: Optional[float] = None
        self._max_ts: Optional[float] = None
        #: raw (unmerged) intervals per phase
        self._ivs: dict[str, list[tuple[float, float]]] = {
            p: [] for p in PHASES
        }
        #: pid -> (last iteration_start ts, last iteration)
        self._last_step: dict[Any, tuple[float, int]] = {}
        #: incident_id -> opened ts (charged to last_ts while still open)
        self._open_incidents: dict[Any, float] = {}
        #: first fault evidence of an unresolved restart window (closed by
        #: the next iteration_start; charged to last_ts if never resolved)
        self._restart_open: Optional[float] = None
        #: step stats: count, sum, max
        self._steps = 0
        self._step_sum = 0.0
        self._step_max = 0.0
        #: rank -> {"first_ts", "last_ts", "train_s", "ckpt_stall_s", "steps"}
        self._ranks: dict[int, dict[str, float]] = {}
        #: compile-cache outcomes (hit/miss/miss_corrupt) — restart-attribution
        #: color: a "hit" restart skipped re-compilation, a "miss" paid it
        self._compile_cache: dict[str, int] = {}
        #: per-phase seconds already published as goodput_update deltas
        self._published: dict[str, float] = {}

    # -- ingest -------------------------------------------------------------

    def observe_many(self, recs: Iterable[dict]) -> None:
        for rec in recs:
            if isinstance(rec, dict):
                self.observe(rec)

    def observe(self, rec: dict) -> None:
        kind = rec.get("kind")
        ts = rec.get("ts")
        if not isinstance(kind, str) or not isinstance(ts, (int, float)):
            return
        if kind == "goodput_update":
            return  # our own narration is derived, not evidence
        self._widen(ts)
        rank = rec.get("rank")
        if isinstance(rank, int):
            rs = self._ranks.setdefault(rank, {
                "first_ts": ts, "last_ts": ts,
                "train_s": 0.0, "ckpt_stall_s": 0.0, "steps": 0,
            })
            rs["first_ts"] = min(rs["first_ts"], ts)
            rs["last_ts"] = max(rs["last_ts"], ts)

        if kind in RESTART_EVIDENCE:
            if self._restart_open is None:
                self._restart_open = ts
        elif kind == "iteration_start":
            if self._restart_open is not None:
                # Training resumed: the restart window closes here, so the
                # respawned interpreter's import/init time is restart cost,
                # not unattributed residue.
                self._ivs["restart"].append((self._restart_open, ts))
                self._restart_open = None
            it = rec.get("iteration")
            if not isinstance(it, int):
                return
            pid = rec.get("pid")
            prev = self._last_step.get(pid)
            if (
                prev is not None and it == prev[1] + 1
                and 0 < ts - prev[0] <= self.max_step_s
            ):
                d = ts - prev[0]
                self._ivs["train"].append((prev[0], ts))
                self._steps += 1
                self._step_sum += d
                self._step_max = max(self._step_max, d)
                if isinstance(rank, int):
                    rs = self._ranks[rank]
                    rs["train_s"] += d
                    rs["steps"] += 1
            self._last_step[pid] = (ts, it)
        elif kind == "ckpt_foreground_blocked":
            self._stall(rec, ts, rank)
        elif kind == "timing" and rec.get("name") in CKPT_STALL_TIMINGS:
            self._stall(rec, ts, rank)
        elif kind == "span_end":
            span = rec.get("span")
            d = rec.get("duration_s")
            if not isinstance(d, (int, float)) or d <= 0:
                return
            if span in RESTART_SPANS:
                self._ivs["restart"].append((ts - d, ts))
                self._widen(ts - d)
            elif span in CKPT_STALL_SPANS:
                self._stall(rec, ts, rank)
        elif kind == "compile_cache":
            outcome = str(rec.get("outcome", "?"))
            self._compile_cache[outcome] = self._compile_cache.get(outcome, 0) + 1
        elif kind == "incident_opened":
            self._open_incidents.setdefault(rec.get("incident_id"), ts)
        elif kind == "incident_closed":
            opened = self._open_incidents.pop(rec.get("incident_id"), None)
            if opened is None:
                # Open fell outside the stream slice: the closed record still
                # knows how far back the fault reaches.
                ttr = rec.get("time_to_recover_s")
                opened = ts - ttr if isinstance(ttr, (int, float)) else ts
            self._ivs["incident"].append((opened, ts))

    def _widen(self, ts: float) -> None:
        """Extend the observed wall-clock window. Duration-carrying records
        widen it backward too — an interval's start is evidence the job was
        already live then, even when it precedes the first record's ts (a
        stream sliced mid-span, or a span whose begin marker was lost)."""
        if self._min_ts is None or ts < self._min_ts:
            self._min_ts = ts
        if self._max_ts is None or ts > self._max_ts:
            self._max_ts = ts

    def _stall(self, rec: dict, ts: float, rank: Any) -> None:
        d = rec.get("duration_s")
        if isinstance(d, (int, float)) and d > 0:
            self._ivs["ckpt_stall"].append((ts - d, ts))
            self._widen(ts - d)
            if isinstance(rank, int):
                self._ranks[rank]["ckpt_stall_s"] += d

    # -- read ---------------------------------------------------------------

    def summary(self) -> dict:
        """The attribution document. Phase seconds + ``unattributed`` sum to
        ``wall_clock_s`` exactly (intervals are clipped to the observed
        window and overlaps resolved by severity)."""
        if self._min_ts is None or self._max_ts is None:
            return {
                "schema": SCHEMA, "wall_clock_s": 0.0, "window": None,
                "phases": {p: 0.0 for p in (*PHASES, "unattributed")},
                "goodput_ratio": 0.0, "steps": 0,
                "step_seconds_mean": None, "step_seconds_max": None,
                "ranks": {}, "compile_cache": {},
            }
        lo, hi = self._min_ts, self._max_ts
        wall = hi - lo
        # Still-open incident/restart windows are charged through
        # end-of-stream: a job that never recovered was not training.
        incident_raw = self._ivs["incident"] + [
            (opened, hi) for opened in self._open_incidents.values()
        ]
        restart_raw = list(self._ivs["restart"])
        if self._restart_open is not None:
            restart_raw.append((self._restart_open, hi))
        raw = {**self._ivs, "incident": incident_raw, "restart": restart_raw}
        occupied: list[tuple[float, float]] = []
        phases: dict[str, float] = {}
        for phase in PHASES:
            merged = merge_intervals(_clip(raw[phase], lo, hi))
            own = subtract_intervals(merged, occupied)
            phases[phase] = round(total_seconds(own), 6)
            occupied = merge_intervals(occupied + own)
        attributed = total_seconds(occupied)
        phases["unattributed"] = round(max(0.0, wall - attributed), 6)
        ranks = {
            str(r): {
                "wall_clock_s": round(rs["last_ts"] - rs["first_ts"], 6),
                "train_s": round(rs["train_s"], 6),
                "ckpt_stall_s": round(rs["ckpt_stall_s"], 6),
                "steps": int(rs["steps"]),
            }
            for r, rs in sorted(self._ranks.items())
        }
        return {
            "schema": SCHEMA,
            "wall_clock_s": round(wall, 6),
            "window": [lo, hi],
            "phases": phases,
            "goodput_ratio": round(phases["train"] / wall, 6) if wall > 0 else 0.0,
            "steps": self._steps,
            "step_seconds_mean": (
                round(self._step_sum / self._steps, 6) if self._steps else None
            ),
            "step_seconds_max": (
                round(self._step_max, 6) if self._steps else None
            ),
            "ranks": ranks,
            # Restart-attribution color: how many process starts found a warm
            # compilation cache (skipped re-compile) vs paid a cold one.
            "compile_cache": dict(sorted(self._compile_cache.items())),
        }

    def publish(
        self, record: Optional[Callable[..., None]] = None
    ) -> dict:
        """Emit per-phase attribution deltas since the previous publish as a
        ``goodput_update`` event (default: through ``events.record``, feeding
        every live sink AND the shared JSONL so post-hoc aggregation replays
        the identical totals). Deltas are clamped at zero: counters are
        monotonic, and late-arriving higher-severity evidence (an incident
        window swallowing already-published train time) skews one publish
        rather than ever un-counting. Returns the summary it published."""
        summary = self.summary()
        deltas = {}
        for phase, seconds in summary["phases"].items():
            d = seconds - self._published.get(phase, 0.0)
            if d > 1e-6:
                deltas[phase] = round(d, 6)
            self._published[phase] = max(seconds, self._published.get(phase, 0.0))
        if deltas:
            (record or events_mod.record)(
                "goodput", "goodput_update",
                phases=deltas, ratio=summary["goodput_ratio"],
                wall_clock_s=summary["wall_clock_s"], steps=summary["steps"],
            )
        return summary


COMPARE_SCHEMA = "tpu-goodput-compare-1"


def compare(a, b) -> dict:
    """Per-phase attribution deltas + ratio delta between two runs (``a``
    minus ``b``). Accepts :class:`GoodputLedger` instances or their
    :meth:`~GoodputLedger.summary` documents.

    This is the autoscale scenario's acceptance arithmetic — "did the
    controlled run beat the no-controller baseline of the same seed?" — and
    a standalone operator tool (``tpu-metrics-dump --goodput --baseline``):
    a positive ``ratio_delta`` means run ``a`` spent a larger fraction of
    its wall clock training."""
    sa = a.summary() if hasattr(a, "summary") else dict(a)
    sb = b.summary() if hasattr(b, "summary") else dict(b)
    pa, pb = sa.get("phases") or {}, sb.get("phases") or {}
    wa, wb = sa.get("wall_clock_s") or 0.0, sb.get("wall_clock_s") or 0.0
    phases = {
        p: round(pa.get(p, 0.0) - pb.get(p, 0.0), 6)
        for p in sorted(set(pa) | set(pb))
    }
    # Fractional deltas normalize away different wall clocks (a controlled
    # run that finishes sooner must not look worse for being shorter).
    phase_frac = {
        p: round(
            (pa.get(p, 0.0) / wa if wa > 0 else 0.0)
            - (pb.get(p, 0.0) / wb if wb > 0 else 0.0),
            6,
        )
        for p in phases
    }
    ra = sa.get("goodput_ratio") or 0.0
    rb = sb.get("goodput_ratio") or 0.0
    return {
        "schema": COMPARE_SCHEMA,
        "wall_clock_s": [round(wa, 6), round(wb, 6)],
        "goodput_ratio": [ra, rb],
        "ratio_delta": round(ra - rb, 6),
        "phases": phases,
        "phase_frac": phase_frac,
        "steps_delta": int((sa.get("steps") or 0) - (sb.get("steps") or 0)),
    }


def render_compare(cmp: dict, out=None, labels=("run", "baseline")) -> None:
    """Operator view of one :func:`compare` document."""
    import sys

    out = sys.stdout if out is None else out
    ra, rb = cmp.get("goodput_ratio") or [0.0, 0.0]
    wa, wb = cmp.get("wall_clock_s") or [0.0, 0.0]
    print(
        f"goodput {labels[0]} {ra:.3f} vs {labels[1]} {rb:.3f} "
        f"(delta {cmp.get('ratio_delta', 0.0):+.3f}; wall {wa:.1f}s vs "
        f"{wb:.1f}s)",
        file=out,
    )
    print("per-phase delta (seconds / share of wall):", file=out)
    fr = cmp.get("phase_frac") or {}
    for phase in ("train", "ckpt_stall", "restart", "incident", "unattributed"):
        if phase not in (cmp.get("phases") or {}):
            continue
        d = cmp["phases"][phase]
        print(
            f"    {phase:<13} {d:>+9.2f} s  {100.0 * fr.get(phase, 0.0):+6.1f}%",
            file=out,
        )
    print(f"steps delta: {cmp.get('steps_delta', 0):+d}", file=out)


def render_table(summary: dict, out=None) -> None:
    """The operator view of one attribution document (offline twin of the
    launcher's ``/goodput`` endpoint — same numbers, table form)."""
    import sys

    out = sys.stdout if out is None else out
    wall = summary.get("wall_clock_s") or 0.0
    ratio = summary.get("goodput_ratio") or 0.0
    phases = summary.get("phases") or {}
    print(
        f"goodput: {ratio:.3f} "
        f"(train {phases.get('train', 0.0):.1f} s / wall {wall:.1f} s)",
        file=out,
    )
    print(f"phase attribution (job wall clock {wall:.1f} s):", file=out)
    for phase in ("train", "ckpt_stall", "restart", "incident", "unattributed"):
        s = phases.get(phase, 0.0)
        pct = (100.0 * s / wall) if wall > 0 else 0.0
        print(f"    {phase:<13} {s:>9.2f} s  {pct:5.1f}%", file=out)
    steps = summary.get("steps") or 0
    if steps:
        mean = summary.get("step_seconds_mean")
        mean_txt = f"{mean * 1e3:.1f} ms" if mean is not None else "-"
        print(f"steps: {steps} (mean {mean_txt})", file=out)
    ranks = summary.get("ranks") or {}
    if ranks:
        print("per-rank:", file=out)
        for r, rs in sorted(ranks.items(), key=lambda kv: int(kv[0])):
            print(
                f"    rank {r}: wall {rs['wall_clock_s']:.1f} s "
                f"train {rs['train_s']:.1f} s "
                f"ckpt {rs['ckpt_stall_s']:.2f} s steps {rs['steps']}",
                file=out,
            )
