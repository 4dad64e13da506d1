"""Byte-flow ledger: one account of every byte the framework moves.

Bytes moved are the currency of ROADMAP's remaining perf work — erasure/delta
replication promises "5-10× fewer bytes per save", reshard promises ranged
fetches instead of whole mirrors — but until this module the evidence was
scattered across four unrelated metric families
(``tpu_ckpt_replication_bytes_total``, ``tpu_ckpt_write_bytes_total``,
``tpu_reshard_bytes_total``, ``tpu_store_bytes_total``) with no common
attribution. The :class:`ByteFlowLedger` is the ``GoodputLedger`` of bytes: a
reducer over the same event stream everything else consumes (live tail or
finished JSONL) that attributes every observed byte to a **(purpose,
direction, peer)** triple and reconciles its own totals against the per-family
counters — the *unaccounted residue is itself a metric*
(``tpu_byteflow_residue_bytes`` / ``tpu_byteflow_accounted_ratio``), because a
byte the instrumentation cannot explain is exactly the kind of byte a 5-10×
reduction claim would silently hide behind.

Attribution sources (all existing emitters; one new field — ``p2p_transfer``
events now carry their transfer ``tag``, whose prefix names the purpose):

======================  =========  ===========================================
event                   purpose    evidence
======================  =========  ===========================================
``p2p_transfer``        replicate  tag ``repl/`` or ``remir/`` (mirror fan-out)
``p2p_transfer``        retrieve   tag ``retr/`` (post-loss shard routing)
``p2p_transfer``        reshard    tag ``rread/`` (ranged-read wire op)
``p2p_transfer``        unknown    tag absent/foreign — the residue
``reshard_fetch``       reshard    assembled bytes, ``via`` local | peer
``ckpt_write_file``     ckpt_write container bytes to disk
``store_stats``         store      coordination-store wire bytes in/out
======================  =========  ===========================================

Surfaces: ``tpu-metrics-dump EVENTS --bytes`` renders the account (table or
``tpu-byteflow-1`` JSON), the launcher's :class:`TelemetryServer` feeds a live
ledger on every refresh and publishes deltas as ``byteflow_update`` events →
``tpu_byteflow_bytes_total{purpose,direction}`` through ``observe_record``, so
the live and post-hoc views agree; the chaos scenarios (``scenario_disk``,
``scenario_elastic``) gate on ``accounted_ratio ≥ 0.95``.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional

from tpu_resiliency_torch.utils import events as events_mod

SCHEMA = "tpu-byteflow-1"

#: transfer-tag prefix → purpose (the p2p wire attribution table). Order
#: matters only for docs; prefixes are disjoint.
TAG_PURPOSES = (
    ("repl/", "replicate"),
    ("remir/", "replicate"),
    ("retr/", "retrieve"),
    ("rread/", "reshard"),
)

#: every purpose the ledger can emit (``unknown`` is the residue bucket)
PURPOSES = ("replicate", "retrieve", "reshard", "store", "ckpt_write", "unknown")

#: the per-family byte counters the ledger reconciles against — family name →
#: (counter family, how the ledger's rows map onto it)
FAMILIES = {
    "p2p": "tpu_ckpt_replication_bytes_total",
    "reshard": "tpu_reshard_bytes_total",
    "ckpt_write": "tpu_ckpt_write_bytes_total",
    "store": "tpu_store_bytes_total",
}


def tag_purpose(tag) -> str:
    if isinstance(tag, str):
        for prefix, purpose in TAG_PURPOSES:
            if tag.startswith(prefix):
                return purpose
    return "unknown"


class ByteFlowLedger:
    """Streamed byte attribution over event records (flat JSONL dict shape).

    Feed with :meth:`observe` / :meth:`observe_many`; read with
    :meth:`summary`; route deltas into the metrics plane with
    :meth:`publish`. Cheap per record: dict increments only."""

    def __init__(self) -> None:
        #: (purpose, direction, peer) -> [bytes, events]
        self._flows: dict[tuple[str, str, str], list] = {}
        #: family -> {"total": bytes, "attributed": bytes}
        self._families: dict[str, dict[str, int]] = {
            f: {"total": 0, "attributed": 0} for f in FAMILIES
        }
        #: per-(purpose/direction) bytes already published as deltas
        self._published: dict[str, float] = {}
        self._published_residue = 0.0

    # -- ingest -------------------------------------------------------------

    def observe_many(self, recs: Iterable[dict]) -> None:
        for rec in recs:
            if isinstance(rec, dict):
                self.observe(rec)

    def observe(self, rec: dict) -> None:
        kind = rec.get("kind")
        if kind == "byteflow_update":
            return  # our own narration is derived, not evidence
        if kind == "p2p_transfer":
            nbytes = rec.get("bytes")
            if not isinstance(nbytes, (int, float)) or nbytes <= 0:
                return
            direction = str(rec.get("direction", "?"))
            purpose = tag_purpose(rec.get("tag"))
            peer = rec.get("dst") if direction == "send" else rec.get("src")
            self._add(purpose, direction, _peer(peer), int(nbytes))
            fam = self._families["p2p"]
            fam["total"] += int(nbytes)
            if purpose != "unknown":
                fam["attributed"] += int(nbytes)
        elif kind == "reshard_fetch":
            nbytes = rec.get("bytes")
            if not isinstance(nbytes, (int, float)) or nbytes <= 0:
                return
            via = str(rec.get("via", "?"))
            # local = container slice read off this rank's own disk; peer =
            # the logical payload of ranged wire fetches (whose wire frames
            # are ALSO visible as rread/-tagged p2p rows — logical vs wire
            # views of the same move, kept as separate directions on purpose).
            direction = "read" if via == "local" else "fetch"
            peer = rec.get("holder") if via == "peer" else "local"
            self._add("reshard", direction, _peer(peer), int(nbytes))
            fam = self._families["reshard"]
            fam["total"] += int(nbytes)
            fam["attributed"] += int(nbytes)
        elif kind == "ckpt_write_file":
            nbytes = rec.get("bytes")
            if not isinstance(nbytes, (int, float)) or nbytes <= 0:
                return
            self._add(
                "ckpt_write", "write", str(rec.get("container", "?")),
                int(nbytes),
            )
            fam = self._families["ckpt_write"]
            fam["total"] += int(nbytes)
            fam["attributed"] += int(nbytes)
        elif kind == "store_stats":
            for field, direction in (("bytes_in", "in"), ("bytes_out", "out")):
                v = rec.get(field)
                if isinstance(v, (int, float)) and v > 0:
                    self._add("store", direction, "store", int(v))
                    fam = self._families["store"]
                    fam["total"] += int(v)
                    fam["attributed"] += int(v)

    def _add(self, purpose: str, direction: str, peer: str, nbytes: int) -> None:
        row = self._flows.get((purpose, direction, peer))
        if row is None:
            row = self._flows[(purpose, direction, peer)] = [0, 0]
        row[0] += nbytes
        row[1] += 1

    # -- read ---------------------------------------------------------------

    def summary(self) -> dict:
        """The attribution document (schema ``tpu-byteflow-1``)."""
        flows = [
            {
                "purpose": p, "direction": d, "peer": peer,
                "bytes": row[0], "events": row[1],
            }
            for (p, d, peer), row in sorted(
                self._flows.items(), key=lambda kv: (-kv[1][0], kv[0])
            )
        ]
        by_purpose = {p: 0 for p in PURPOSES}
        for f in flows:
            by_purpose[f["purpose"]] = by_purpose.get(f["purpose"], 0) + f["bytes"]
        by_purpose = {p: b for p, b in by_purpose.items() if b}
        families = {}
        total = attributed = 0
        for name, fam in sorted(self._families.items()):
            residue = fam["total"] - fam["attributed"]
            families[name] = {
                "counter": FAMILIES[name],
                "total": fam["total"],
                "attributed": fam["attributed"],
                "residue": residue,
                "residue_frac": (
                    round(residue / fam["total"], 6) if fam["total"] else 0.0
                ),
            }
            total += fam["total"]
            attributed += fam["attributed"]
        return {
            "schema": SCHEMA,
            "total_bytes": total,
            "attributed_bytes": attributed,
            "residue_bytes": total - attributed,
            "accounted_frac": round(attributed / total, 6) if total else 1.0,
            "by_purpose": by_purpose,
            "flows": flows,
            "families": families,
        }

    def reconcile(self, registry) -> dict:
        """Cross-check ledger family totals against a
        :class:`~tpu_resiliency_torch.utils.metrics.MetricsRegistry` built from the
        same stream: both derive from one event set through independent code
        paths, so any drift means an emitter the ledger (or the counter
        mapping) does not understand. Returns per-family
        ``{counter, ledger, drift}`` rows."""
        snap = registry.snapshot().get("metrics") or {}
        out = {}
        for name, fam in sorted(self._families.items()):
            counter_total = sum(
                e.get("value") or 0.0 for e in snap.get(FAMILIES[name]) or []
            )
            out[name] = {
                "counter": FAMILIES[name],
                "counter_bytes": counter_total,
                "ledger_bytes": fam["total"],
                "drift_bytes": round(counter_total - fam["total"], 3),
            }
        return out

    def publish(self, record: Optional[Callable[..., None]] = None) -> dict:
        """Emit per-flow byte deltas since the previous publish as ONE
        ``byteflow_update`` event (default: through ``events.record``), the
        ``goodput_update`` discipline — replaying the stream reconstructs the
        live ``tpu_byteflow_*`` totals exactly. Returns the summary."""
        summary = self.summary()
        deltas: dict[str, int] = {}
        for (p, d, _peer_), row in self._flows.items():
            key = f"{p}/{d}"
            deltas[key] = deltas.get(key, 0) + row[0]
        moved = {}
        for key, total in sorted(deltas.items()):
            delta = total - self._published.get(key, 0)
            if delta > 0:
                moved[key] = delta
            self._published[key] = total
        residue_delta = summary["residue_bytes"] - self._published_residue
        self._published_residue = max(
            summary["residue_bytes"], self._published_residue
        )
        if moved or residue_delta > 0:
            (record or events_mod.record)(
                "byteflow", "byteflow_update",
                flows=moved,
                residue_bytes=max(0, residue_delta),
                accounted_ratio=summary["accounted_frac"],
                total_bytes=summary["total_bytes"],
            )
        return summary


def _peer(peer) -> str:
    if peer is None:
        return "?"
    return f"r{peer}" if isinstance(peer, int) else str(peer)


def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KB", "MB", "GB"):
        if abs(n) < 1024.0 or unit == "GB":
            return f"{n:.1f} {unit}" if unit != "B" else f"{int(n)} B"
        n /= 1024.0
    return f"{n:.1f} GB"


def render_table(summary: dict, out=None, reconcile: Optional[dict] = None) -> None:
    """Operator view of one attribution document (the ``--bytes`` report)."""
    import sys

    out = sys.stdout if out is None else out
    total = summary.get("total_bytes") or 0
    frac = summary.get("accounted_frac")
    print(
        f"byte flow: {_fmt_bytes(total)} observed, "
        f"{100.0 * (frac or 0.0):.1f}% attributed "
        f"(residue {_fmt_bytes(summary.get('residue_bytes') or 0)})",
        file=out,
    )
    by_purpose = summary.get("by_purpose") or {}
    if by_purpose:
        print("by purpose:", file=out)
        for p in sorted(by_purpose, key=lambda k: -by_purpose[k]):
            share = 100.0 * by_purpose[p] / total if total else 0.0
            print(f"    {p:<11} {_fmt_bytes(by_purpose[p]):>12}  {share:5.1f}%",
                  file=out)
    flows = summary.get("flows") or []
    if flows:
        print("flows (purpose / direction / peer):", file=out)
        for f in flows[:20]:
            print(
                f"    {f['purpose']:<11} {f['direction']:<6} "
                f"{str(f['peer']):<10} {_fmt_bytes(f['bytes']):>12} "
                f"({f['events']} events)",
                file=out,
            )
        if len(flows) > 20:
            print(f"    ... {len(flows) - 20} more flows", file=out)
    fams = summary.get("families") or {}
    if fams:
        print("reconciliation vs metric families:", file=out)
        for name, fam in sorted(fams.items()):
            line = (
                f"    {fam['counter']:<36} {_fmt_bytes(fam['total']):>12}"
                f"  residue {_fmt_bytes(fam['residue'])}"
                f" ({100.0 * fam['residue_frac']:.1f}%)"
            )
            if reconcile and name in reconcile:
                drift = reconcile[name]["drift_bytes"]
                line += f"  counter drift {_fmt_bytes(drift)}"
            print(line, file=out)
