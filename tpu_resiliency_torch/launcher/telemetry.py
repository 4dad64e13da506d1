"""Live telemetry endpoint on the launcher agent.

Everything the observability plane records was, until this module, offline:
metrics lived in per-rank files and every CLI replayed a finished JSONL. The
:class:`TelemetryServer` turns the launcher into the job's scrape target — a
stdlib ``http.server`` thread on an ephemeral port with a port-file handshake
(no port flag coordination; a sidecar reads ``telemetry.port`` out of the run
dir), serving three endpoints:

- ``GET /metrics`` — the **merged job-level** Prometheus view: the launcher's
  own registry folded together with every rank-published snapshot from the
  coordination store (``utils/metrics.py:MetricsPublisher`` push path +
  ``MetricsRegistry.merge``). One scrape answers for N ranks; no scraper ever
  opens a rank's files.
- ``GET /goodput`` — the goodput ledger's attribution document as JSON
  (``utils/goodput.py``): wall clock classified into train / ckpt_stall /
  restart / incident / unattributed, goodput ratio, per-rank rows. The ledger
  tails the shared events JSONL incrementally, so a scrape costs only the
  bytes appended since the last one.
- ``GET /healthz`` — the agent's current health decision as JSON; HTTP 200
  when healthy, 503 when not (load-balancer / watchdog friendly).
- ``GET /hangz`` — the live blocked-collective census as JSON
  (``schema: tpu-hangz-1``): per-rank last-known location + stuck duration
  (from each rank's monitor), every open barrier round with its arrived /
  missing / absent ranks and waiter ages (the store's ``barrier_census``
  op), and ranked hang suspects — "who is stuck where, and who never
  arrived", while the job is still wedged.
- ``GET /autoscale`` — the autoscale controller's status document
  (``schema: tpu-autoscale-1``, ``launcher/autoscale.py``): mode, pending
  preemption notices, the recent decision audit with predicted AND realized
  goodput deltas, forecast accuracy, and the live cost-model constants.
- ``GET /metrics.json`` — the same merged job-level view as ``/metrics``, as
  a mergeable JSON snapshot (``MetricsRegistry.snapshot`` format): the
  federation input — fleetd folds these with ``MetricsRegistry.merge``
  instead of parsing exposition text.
- ``GET /incidents`` — recent ``tpu-incident-1`` artifact summaries from the
  incidents dir (``schema: tpu-incidents-1``; heavyweight fields — event
  window, flight dumps — trimmed to counts).
- ``GET /snapshot`` — the consolidated per-job document
  (``schema: tpu-job-snapshot-1``): metrics snapshot + goodput + health +
  hangz + incidents in ONE round trip, so a fleet scrape costs one GET per
  job (``tools/fleetd.py``).
- ``GET /storez`` — the coordination store's live self-telemetry document
  (``schema: tpu-storez-1``, wrapping the ``store_stats`` wire op's
  ``tpu-store-stats-1`` body): per-op latency with queue-wait/handle split,
  bytes in/out, connection counts, dedup hit rate, barrier park depth, hot
  key prefixes. Folded into ``/snapshot`` so fleetd gets it for free; a
  crashing collector degrades the document, never the endpoint.
- ``GET /alerts`` — the SLO watchtower's state document
  (``schema: tpu-alerts-1``, ``telemetry/watchtower.py``): the loaded rule
  table with per-rule state (ok / pending / firing / error), the
  severity-ranked active alerts, recent fire/resolve history, and the ring
  census. The watchtower rides the same incremental events tail as the
  ledgers, so every refresh advances its rings too; a crashing rule degrades
  to an error row on its rule entry, never a non-200. Folded into
  ``/snapshot`` so fleetd gets the fleet-wide alert feed for free.

``/healthz`` results are TTL-cached (``health_ttl``, default 1 s) behind a
lock, so a scrape storm from fleet pollers costs one ``health_fn``
evaluation per TTL instead of stacking concurrent runs.

**Fleet registration**: with ``fleet_dir`` set (launcher ``--fleet-dir``),
the server announces the job to the fleet control plane by writing an atomic
``tpu-fleet-lease-1`` lease file (job id, url, pid, started_at) into the
shared directory and heartbeat-refreshing it every ``lease_interval``
seconds; a clean ``stop()`` removes the lease, a crash lets it go stale and
fleetd expires it (``fleet/registry.py``) — the same announce/teardown
discipline as the ``telemetry.port`` handshake, shared-directory-wide.

Each ``/metrics`` or ``/goodput`` request also refreshes the ledger and
publishes attribution deltas back through the event stream
(``goodput_update`` → ``tpu_time_attributed_seconds_total{phase}`` /
``tpu_goodput_ratio``), so the Prometheus view and the post-hoc
``tpu-metrics-dump`` aggregation of the same JSONL stay in parity.
"""

from __future__ import annotations

import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

from tpu_resiliency_torch.utils import events as events_mod
from tpu_resiliency_torch.utils.goodput import GoodputLedger
from tpu_resiliency_torch.utils.logging import get_logger
from tpu_resiliency_torch.utils.metrics import MetricsRegistry, MetricsSink, observe_record

log = get_logger(__name__)

#: default name of the port-file handshake inside the launcher's run dir
PORT_FILE_NAME = "telemetry.port"


class TelemetryServer:
    """Threaded HTTP endpoint serving /metrics, /goodput, /healthz.

    ``fetch_snapshots`` returns the rank-published snapshot documents (the
    agent wires a store prefix scan); ``health_fn`` returns the health
    document (``{"healthy": bool, ...}``). Both are optional — without them
    the server still serves the launcher-local registry and the ledger.
    """

    def __init__(
        self,
        *,
        port: int = 0,
        host: str = "127.0.0.1",
        port_file: Optional[str] = None,
        events_file: Optional[str] = None,
        registry: Optional[MetricsRegistry] = None,
        fetch_snapshots: Optional[Callable[[], list]] = None,
        health_fn: Optional[Callable[[], dict]] = None,
        census_fn: Optional[Callable[[], dict]] = None,
        autoscale_fn: Optional[Callable[[], dict]] = None,
        store_stats_fn: Optional[Callable[[], dict]] = None,
        health_ttl: float = 1.0,
        fleet_dir: Optional[str] = None,
        job: str = "default",
        node_id: str = "",
        incidents_dir: Optional[str] = None,
        lease_interval: float = 5.0,
        snapshot_ttl: float = 1.0,
        watchtower=None,
    ):
        self.registry = registry if registry is not None else MetricsRegistry()
        self.ledger = GoodputLedger()
        # The byte-flow ledger rides the same incremental tail as the goodput
        # ledger, so the live tpu_byteflow_* view and a post-hoc
        # `tpu-metrics-dump --bytes` of the same stream agree.
        from tpu_resiliency_torch.utils.byteflow import ByteFlowLedger

        self.byteflow = ByteFlowLedger()
        self._host = host
        self._want_port = port
        self.port_file = port_file
        self.events_file = events_file
        self.fetch_snapshots = fetch_snapshots
        self.health_fn = health_fn
        self.census_fn = census_fn
        self.autoscale_fn = autoscale_fn
        self.store_stats_fn = store_stats_fn
        #: SLO watchtower (``telemetry/watchtower.py``): fed from the same
        #: events tail the ledgers ride; None keeps /alerts degraded-but-200.
        self.watchtower = watchtower
        #: fleet discovery (``fleet/registry.py``): directory the job's lease
        #: lives in; None keeps the server single-job (no registration).
        self.fleet_dir = fleet_dir
        self.job = job or "default"
        self.node_id = node_id
        self.incidents_dir = incidents_dir
        self.lease_interval = lease_interval
        self._lease = None
        self._lease_stop = threading.Event()
        self._lease_thread: Optional[threading.Thread] = None
        #: /snapshot body cache lifetime: the consolidated document is the
        #: fleet-scrape hot path, and several fleetds / dashboards polling one
        #: job must cost one ledger-refresh + registry-merge + serialize per
        #: TTL, not one per scraper (the /healthz discipline, one level up).
        #: 0 disables caching (computation still serializes under the lock).
        self.snapshot_ttl = snapshot_ttl
        self._snapshot_lock = threading.Lock()
        self._snapshot_cache: Optional[tuple[float, bytes]] = None
        #: /healthz result cache lifetime: a scrape storm (fleet pollers all
        #: hitting one launcher) must not stack concurrent health_fn runs.
        #: 0 disables caching (computation still serializes under the lock).
        self.health_ttl = health_ttl
        self._health_lock = threading.Lock()
        self._health_cache: Optional[tuple[float, dict]] = None
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        #: byte offset of the last complete line consumed from events_file
        self._offset = 0
        self._refresh_lock = threading.Lock()
        self._sink: Optional[MetricsSink] = None

    # -- lifecycle ----------------------------------------------------------

    @property
    def port(self) -> Optional[int]:
        return self._httpd.server_address[1] if self._httpd else None

    def start(self) -> int:
        """Bind, write the port file, start serving. Returns the bound port."""
        server = self

        class Handler(BaseHTTPRequestHandler):
            # Keep-alive: a fleet scraper's per-beat GET rides one persistent
            # connection (and one server-side handler thread) instead of
            # paying TCP setup + thread spawn per scrape. Every response
            # already carries Content-Length, which 1.1 requires.
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # no stderr chatter
                log.debug(f"telemetry: {fmt % args}")

            def do_GET(self):
                try:
                    server._handle(self)
                except BrokenPipeError:
                    pass
                except Exception:
                    log.debug("telemetry request failed", exc_info=True)
                    try:
                        self.send_error(500)
                    except Exception:
                        pass

        self._httpd = ThreadingHTTPServer((self._host, self._want_port), Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="telemetry-http", daemon=True
        )
        self._thread.start()
        # The launcher's own events feed the local half of the merged view.
        self._sink = MetricsSink(self.registry)
        events_mod.add_sink(self._sink)
        port = self._httpd.server_address[1]
        if self.port_file:
            d = os.path.dirname(self.port_file)
            if d:
                os.makedirs(d, exist_ok=True)
            tmp = f"{self.port_file}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                f.write(f"{port}\n")
            os.replace(tmp, self.port_file)
        if self.fleet_dir:
            self._register_lease(port)
        if self.watchtower is not None:
            # The pump: alerts fire and resolve on schedule even when nobody
            # scrapes (refresh tails the events file into the watchtower).
            self.watchtower.start(poll_fn=self.refresh)
        log.info(f"telemetry endpoint on http://{self._host}:{port} "
                 f"(/metrics /goodput /healthz /hangz /autoscale /snapshot "
                 f"/storez /alerts)")
        return port

    def stop(self) -> None:
        if self.watchtower is not None:
            self.watchtower.stop()
        if self._lease_thread is not None:
            self._lease_stop.set()
            self._lease_thread.join(timeout=5.0)
            self._lease_thread = None
        if self._lease is not None:
            # Clean stop: the job disappears from the fleet view immediately
            # instead of lingering until heartbeat staleness.
            from tpu_resiliency_torch.fleet.registry import remove_lease

            remove_lease(self._lease.path)
            self._lease = None
        if self._sink is not None:
            events_mod.remove_sink(self._sink)
            self._sink = None
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        if self.port_file:
            try:
                os.unlink(self.port_file)
            except OSError:
                pass

    # -- fleet registration -------------------------------------------------

    def _register_lease(self, port: int) -> None:
        """Announce this job to the fleet dir and start the heartbeat. A
        registration failure degrades to single-job serving — discovery is
        observability, never control flow."""
        from tpu_resiliency_torch.fleet.registry import JobLease, write_lease

        self._lease = JobLease(
            job=self.job,
            url=f"http://{self._host}:{port}",
            pid=os.getpid(),
            node_id=self.node_id,
            started_at=time.time(),
        )
        try:
            write_lease(self.fleet_dir, self._lease)
        except OSError as e:
            log.warning(f"cannot register fleet lease in {self.fleet_dir!r}: {e}")
            self._lease = None
            return
        self._lease_stop.clear()
        self._lease_thread = threading.Thread(
            target=self._lease_loop, name="fleet-lease", daemon=True
        )
        self._lease_thread.start()

    def _lease_loop(self) -> None:
        while not self._lease_stop.wait(self.lease_interval):
            lease = self._lease
            if lease is None:
                return
            try:
                # Each refresh is a full atomic rewrite stamping a fresh
                # heartbeat_ts — fleetd treats a stale stamp as a dead job.
                from tpu_resiliency_torch.fleet.registry import write_lease

                write_lease(self.fleet_dir, lease)
            except OSError:
                log.debug("fleet lease refresh failed", exc_info=True)

    # -- request handling ---------------------------------------------------

    def _handle(self, req: BaseHTTPRequestHandler) -> None:
        path = req.path.split("?", 1)[0]
        if path == "/metrics":
            self.refresh()
            body = self.merged_registry().to_prometheus().encode()
            self._respond(req, 200, body, "text/plain; version=0.0.4")
        elif path == "/metrics.json":
            self.refresh()
            doc = self.merged_registry().snapshot()
            self._respond(req, 200, _json_body(doc), "application/json")
        elif path == "/incidents":
            self._respond(
                req, 200, _json_body(self._incidents_doc()), "application/json"
            )
        elif path == "/snapshot":
            self._respond(req, 200, self._snapshot_body(), "application/json")
        elif path == "/goodput":
            summary = self.refresh()
            self._respond(req, 200, _json_body(summary), "application/json")
        elif path == "/healthz":
            doc = self._health_doc()
            status = 200 if doc.get("healthy") else 503
            self._respond(req, status, _json_body(doc), "application/json")
        elif path == "/autoscale":
            if self.autoscale_fn is None:
                doc = {"schema": "tpu-autoscale-1", "mode": "off",
                       "error": "no autoscale controller wired"}
            else:
                try:
                    doc = dict(self.autoscale_fn())
                except Exception as e:
                    # A broken controller degrades the document, never the
                    # endpoint — same contract as /hangz.
                    doc = {"schema": "tpu-autoscale-1", "error": repr(e)}
            doc.setdefault("schema", "tpu-autoscale-1")
            self._respond(req, 200, _json_body(doc), "application/json")
        elif path == "/hangz":
            if self.census_fn is None:
                doc = {"schema": "tpu-hangz-1", "error": "no census source wired"}
            else:
                try:
                    doc = dict(self.census_fn())
                except Exception as e:
                    # A wedged store/monitor must degrade the census, not the
                    # endpoint — /hangz exists precisely for wedged moments.
                    doc = {"schema": "tpu-hangz-1", "error": repr(e)}
            doc.setdefault("schema", "tpu-hangz-1")
            self._respond(req, 200, _json_body(doc), "application/json")
        elif path == "/storez":
            self._respond(
                req, 200, _json_body(self._storez_doc()), "application/json"
            )
        elif path == "/alerts":
            self._respond(
                req, 200, _json_body(self._alerts_doc()), "application/json"
            )
        else:
            self._respond(
                req, 404,
                _json_body({"error": f"unknown path {path!r}",
                            "endpoints": ["/metrics", "/metrics.json",
                                          "/goodput", "/healthz", "/hangz",
                                          "/autoscale", "/incidents",
                                          "/snapshot", "/storez", "/alerts"]}),
                "application/json",
            )

    def _storez_doc(self) -> dict:
        """The /storez body (schema ``tpu-storez-1``): the coordination
        store's ``store_stats`` document wrapped with the job identity. A
        crashing collector — or a store that predates the op — degrades the
        document to an ``error`` field, never the endpoint (the /hangz
        contract: the forensics plane must answer during the incidents it
        exists for)."""
        doc: dict = {"schema": "tpu-storez-1", "job": self.job}
        if self.store_stats_fn is None:
            doc["error"] = "no store stats source wired"
            return doc
        try:
            doc.update(dict(self.store_stats_fn()))
        except Exception as e:
            doc["error"] = repr(e)
        doc["schema"] = "tpu-storez-1"
        return doc

    def _alerts_doc(self) -> dict:
        """The /alerts body (schema ``tpu-alerts-1``). The watchtower already
        contains crashing rules to error rows; this guard covers a wedged
        engine itself — the document degrades, never the endpoint. A refresh
        first, so a scrape sees alerts derived from every complete line the
        events file holds right now (same freshness contract as /goodput)."""
        if self.watchtower is None:
            return {"schema": "tpu-alerts-1", "job": self.job,
                    "error": "no watchtower wired"}
        try:
            self.refresh()
            doc = dict(self.watchtower.status())
        except Exception as e:
            doc = {"schema": "tpu-alerts-1", "error": repr(e)}
        doc.setdefault("schema", "tpu-alerts-1")
        doc.setdefault("job", self.job)
        return doc

    def _health_doc(self) -> dict:
        """The /healthz body, TTL-cached. Computation happens INSIDE the lock
        on purpose: two concurrent scrapes during a slow health_fn serialize,
        and the second returns the first's fresh result instead of running
        health_fn again — a scrape storm costs one evaluation per TTL."""
        with self._health_lock:
            now = time.monotonic()
            if (
                self._health_cache is not None
                and now - self._health_cache[0] < self.health_ttl
            ):
                return self._health_cache[1]
            doc = {"healthy": True}
            if self.health_fn is not None:
                try:
                    doc = dict(self.health_fn())
                except Exception as e:
                    doc = {"healthy": False, "error": repr(e)}
            self._health_cache = (time.monotonic(), doc)
            return doc

    #: incident feed length cap: the fleet wants the recent tail, not a
    #: job-lifetime archive (artifacts on disk remain the full record)
    INCIDENTS_LIMIT = 50

    def _incidents_doc(self) -> dict:
        """Recent incident-artifact summaries, newest first. Heavy forensic
        fields (event window, flight dumps, chain, census) are trimmed to
        counts — the fleet feed answers "what happened, when, how bad";
        ``tpu-incident-report`` against the artifact answers "why"."""
        doc: dict = {"schema": "tpu-incidents-1", "job": self.job, "incidents": []}
        if not self.incidents_dir:
            return doc
        try:
            names = [
                n for n in os.listdir(self.incidents_dir)
                if n.startswith("incident-") and n.endswith(".json")
            ]
        except OSError as e:
            doc["error"] = repr(e)
            return doc
        for name in sorted(names, reverse=True)[: self.INCIDENTS_LIMIT]:
            try:
                with open(os.path.join(self.incidents_dir, name)) as f:
                    art = json.load(f)
            except (OSError, json.JSONDecodeError, UnicodeDecodeError):
                continue  # torn/foreign file: skip, never degrade the feed
            if not isinstance(art, dict) or art.get("schema") != "tpu-incident-1":
                continue
            doc["incidents"].append({
                "id": art.get("id"),
                "trigger": art.get("trigger"),
                "detail": art.get("detail"),
                "outcome": art.get("outcome"),
                "ranks": art.get("ranks"),
                "node_id": art.get("node_id"),
                "opened_ts": art.get("opened_ts"),
                "closed_ts": art.get("closed_ts"),
                "fault_ts": art.get("fault_ts"),
                "slo": art.get("slo"),
                "events": len(art.get("events") or []),
                "chain": len(art.get("chain") or []),
                "flight_dumps": len(art.get("flight") or {}),
                "artifact": name,
            })
        doc["incidents"].sort(
            key=lambda i: -(i.get("opened_ts") if isinstance(
                i.get("opened_ts"), (int, float)) else 0.0)
        )
        return doc

    def snapshot_doc(self) -> dict:
        """The consolidated per-job document — one GET answers a fleet
        scrape (``schema: tpu-job-snapshot-1``). Every section degrades
        independently: a wedged census or crashed health_fn yields an error
        field in its section, never a failed snapshot."""
        goodput = self.refresh()
        doc: dict = {
            "schema": "tpu-job-snapshot-1",
            "job": self.job,
            "node_id": self.node_id,
            "pid": os.getpid(),
            "ts": time.time(),
            "metrics": self.merged_registry().snapshot(),
            "goodput": goodput,
            "health": self._health_doc(),
            "incidents": self._incidents_doc()["incidents"],
        }
        if self.census_fn is not None:
            try:
                doc["hangz"] = dict(self.census_fn())
            except Exception as e:
                doc["hangz"] = {"error": repr(e)}
            doc["hangz"].setdefault("schema", "tpu-hangz-1")
        if self.autoscale_fn is not None:
            try:
                doc["autoscale"] = dict(self.autoscale_fn())
            except Exception as e:
                doc["autoscale"] = {"error": repr(e)}
            doc["autoscale"].setdefault("schema", "tpu-autoscale-1")
        if self.store_stats_fn is not None:
            doc["storez"] = self._storez_doc()
        if self.watchtower is not None:
            try:
                doc["alerts"] = dict(self.watchtower.status())
            except Exception as e:
                doc["alerts"] = {"error": repr(e)}
            doc["alerts"].setdefault("schema", "tpu-alerts-1")
        return doc

    def _snapshot_body(self) -> bytes:
        """The /snapshot response bytes, TTL-cached. Compute-inside-the-lock
        like ``_health_doc``: concurrent fleet scrapers during a slow build
        serialize, and the laggards reuse the fresh bytes — rendered once,
        not once per scraper."""
        with self._snapshot_lock:
            now = time.monotonic()
            if (
                self._snapshot_cache is not None
                and now - self._snapshot_cache[0] < self.snapshot_ttl
            ):
                return self._snapshot_cache[1]
            body = _json_body(self.snapshot_doc())
            self._snapshot_cache = (time.monotonic(), body)
            return body

    @staticmethod
    def _respond(
        req: BaseHTTPRequestHandler, status: int, body: bytes, ctype: str
    ) -> None:
        req.send_response(status)
        req.send_header("Content-Type", ctype)
        req.send_header("Content-Length", str(len(body)))
        req.end_headers()
        req.wfile.write(body)

    # -- data assembly ------------------------------------------------------

    def refresh(self) -> dict:
        """Feed the ledger the events appended since the last refresh, then
        publish attribution deltas through the event stream (which lands in
        the local registry via the attached sink AND in the shared JSONL for
        post-hoc parity). Returns the current summary."""
        with self._refresh_lock:
            for rec in self._read_new_events():
                self.ledger.observe(rec)
                self.byteflow.observe(rec)
                if self.watchtower is not None:
                    # Same tail, same order — the watchtower's stream clock
                    # advances exactly as an offline replay of this file would.
                    self.watchtower.observe(rec)
            self.byteflow.publish()
            return self.ledger.publish()

    def _read_new_events(self) -> list[dict]:
        if not self.events_file:
            return []
        out: list[dict] = []
        try:
            with open(self.events_file, "rb") as f:
                f.seek(self._offset)
                chunk = f.read()
        except OSError:
            return []
        if not chunk:
            return []
        # Only complete lines advance the offset: a torn trailing line is
        # re-read whole on the next refresh.
        end = chunk.rfind(b"\n")
        if end < 0:
            return []
        self._offset += end + 1
        for line in chunk[: end + 1].splitlines():
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except (json.JSONDecodeError, UnicodeDecodeError):
                continue
            if isinstance(rec, dict):
                out.append(rec)
        return out

    def merged_registry(self) -> MetricsRegistry:
        """Fold the launcher-local registry and every rank-published snapshot
        into one fresh job-level registry (the /metrics body)."""
        merged = MetricsRegistry()
        merged.merge(self.registry.snapshot())
        if self.fetch_snapshots is not None:
            try:
                snapshots = self.fetch_snapshots() or []
            except Exception:
                log.debug("snapshot fetch failed", exc_info=True)
                snapshots = []
            for snap in snapshots:
                try:
                    merged.merge(snap)
                except (ValueError, TypeError):
                    log.debug("skipping unmergeable snapshot", exc_info=True)
        return merged

    def observe(self, rec: dict) -> None:
        """Feed one flat record straight into local registry + ledgers (tests
        and embedders without an events file)."""
        observe_record(rec, self.registry)
        self.ledger.observe(rec)
        self.byteflow.observe(rec)
        if self.watchtower is not None:
            self.watchtower.observe(rec)


def _json_body(doc: dict) -> bytes:
    return (json.dumps(doc, indent=2) + "\n").encode()
