"""The port's fault-tolerant elastic launcher CLI: ``python -m tpu_resiliency_torch.launcher.launch``.

A copy of ``tpu_resiliency/launcher/launch.py`` (``tpu-ft-launcher``) with every flag of
its parser. Warm spares preload ``torch``; ``--compile-cache-dir`` exports
torch.compile's cache variables (``platform/compile_cache.py``). ``--fleet-dir``,
whose modules the port does not hold yet, exits with an error naming them
(``agent.UNPORTED_FEATURES``). Its docstring follows.

Analogue of the reference's ``ft_launcher`` console script
(``fault_tolerance/launcher.py:2065 main``, CLI surface ``:739 LaunchConfig``): spawns
``--nproc-per-node`` workers per host under a per-host elastic agent with per-rank
hang monitors, restarts on failure up to ``--max-restarts``, supports elastic
``--nnodes MIN:MAX`` with spares and optional upscaling, ``--restart-policy
{any-failed,min-healthy}``, YAML fault-tolerance config with ``--ft-param-*``
overrides (``config.py:144``), and per-round/per-rank log capture.

Store hosting: the agent whose ``--rdzv-endpoint`` port is free on the local machine
binds the coordination KVServer itself (rank-0-hosts pattern); everyone else connects
as a client. A multi-host job therefore needs no separate store daemon — start the
first agent on the endpoint host.

Example::

    python -m tpu_resiliency_torch.launcher.launch --nproc-per-node 4 --nnodes 2:3 \\
        --rdzv-endpoint host0:29511 --max-restarts 5 train.py --lr 3e-4
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Optional

from tpu_resiliency_torch.launcher.agent import (
    AgentConfig,
    ElasticAgent,
    WorkersFailed,
    unported,
)
from tpu_resiliency_torch.platform.store import (
    AUTH_KEY_ENV,
    CoordStore,
    KVServer,
    store_answers,
)
from tpu_resiliency_torch.utils.events import EVENTS_FILE_ENV, METRICS_FILE_ENV
from tpu_resiliency_torch.utils.logging import get_logger
from tpu_resiliency_torch.utils.tracing import ensure_trace_id, span
from tpu_resiliency_torch.watchdog.config import FaultToleranceConfig

log = get_logger(__name__)

STORE_PREFIX = "launcher/"


def parse_nnodes(spec: str) -> tuple[int, int]:
    if ":" in spec:
        lo, hi = spec.split(":", 1)
        return int(lo), int(hi)
    n = int(spec)
    return n, n


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tpu-ft-launcher",
        description="Fault-tolerant elastic launcher for PyTorch training workloads "
        "on CUDA cards.",
        allow_abbrev=False,
    )
    p.add_argument("--nproc-per-node", type=int, default=1)
    # None defaults let the conflict check distinguish "omitted" from "typed the
    # default value" — main() fills in '1' / '127.0.0.1:29511'.
    p.add_argument(
        "--nnodes",
        default=None,
        help="node count, fixed ('2') or elastic range ('MIN:MAX'); surplus joiners "
        "become spares (the reference's redundancy list); default 1",
    )
    p.add_argument(
        "--rdzv-endpoint", default=None,
        help="host:port of the store (default 127.0.0.1:29511)",
    )
    p.add_argument(
        "--rdzv-id",
        default="default",
        help="job identity namespacing the coordination state: two jobs sharing "
        "one store server never see each other's rendezvous (reference --rdzv-id)",
    )
    p.add_argument(
        "--store-shards", type=int, default=1,
        help="host the coordination store as a clique of N server processes "
        "(shard 0 on the endpoint port) with the keyspace hash-partitioned "
        "client-side (crc32(key) %% N); workers and monitors inherit the "
        "clique via $TPU_RESILIENCY_STORE_SHARDS, and barriers/watch-parks "
        "stay shard-local because a name hashes to one shard. 1 (default) "
        "keeps today's single in-process server",
    )
    p.add_argument(
        "--store-replicate", action="store_true",
        help="HA clique: every key is written to its home shard AND the "
        "successor shard ((h+1) %% N), so a SIGKILL'd shard's keyspace — "
        "barriers included — stays servable from the successor while the "
        "clique is degraded; clients fail over automatically once the "
        "shard's circuit breaker opens. Descendants inherit via "
        "$TPU_RESILIENCY_STORE_REPLICATE. No effect with --store-shards 1 "
        "(successor == primary: the degenerate clique replicates nothing)",
    )
    p.add_argument(
        "--store-auto-reshard", action="store_true",
        help="automatic shard respawn for a job-hosted store clique: the "
        "launcher watches each shard's process + circuit-breaker telemetry "
        "and, when one stays dead past a grace window, spawns a replacement "
        "KVServer and drives reshard_clique onto the healed map (audited as "
        "store_auto_reshard events); operator-initiated resharding is "
        "unchanged. No effect unless this launcher hosts the clique "
        "(--store-shards > 1)",
    )
    p.add_argument(
        "--standalone",
        action="store_true",
        help="single-node convenience: host the store on an ephemeral local port "
        "and pin --nnodes 1 (reference --standalone)",
    )
    p.add_argument("--node-id", default="", help="stable node identity (default: generated)")
    p.add_argument("--max-restarts", type=int, default=3)
    p.add_argument(
        "--restart-policy", choices=("any-failed", "min-healthy"), default="any-failed"
    )
    p.add_argument("--monitor-interval", type=float, default=0.5)
    p.add_argument(
        "--rdzv-last-call",
        type=float,
        default=1.0,
        help="seconds the leader holds a rendezvous round open after min nodes arrive",
    )
    p.add_argument(
        "--rdzv-keep-alive-interval", type=float, default=2.0,
        help="agent keep-alive stamp period",
    )
    p.add_argument(
        "--rdzv-keep-alive-timeout", type=float, default=20.0,
        help="agents with keep-alives staler than this are treated as dead",
    )
    p.add_argument("--upscaling-enabled", action="store_true")
    p.add_argument(
        "--warm-spares",
        type=int,
        default=0,
        help="parked pre-imported interpreters kept warm per node; restart "
        "rounds promote one instead of paying interpreter+import startup "
        "(beats the reference's cold start_processes respawn path)",
    )
    p.add_argument(
        "--warm-spare-preload",
        default="torch",
        help="comma-separated modules each warm spare imports while parked",
    )
    p.add_argument(
        "--warm-spare-warmup",
        default="imports",
        help="park phase for warm spares: 'imports' (preloads only, default), "
        "'runtime' (platform-safe runtime warmup: the port's packages imported, "
        "its built kernel libraries opened, one CPU operation, no CUDA context — "
        "device grabbing stays strictly post-promotion), or a custom "
        "'module:function' spec; "
        "deeper-warmed spares are promoted first",
    )
    p.add_argument(
        "--compile-cache-dir",
        default=None,
        help="persistent torch.compile caches shared across restart rounds "
        "(exports $TORCHINDUCTOR_CACHE_DIR, $TRITON_CACHE_DIR and "
        "$TPU_RESILIENCY_COMPILE_CACHE_DIR to workers): a respawned worker's "
        "first compiled step loads the previous round's artifacts instead of "
        "re-compiling; corrupt entries are swept to a cold "
        "compile, never a crash",
    )
    p.add_argument(
        "--no-rdzv-fast-path",
        action="store_true",
        help="disable restart fast-path rendezvous (round reuse); replacement "
        "rounds always take the full open/join/close ladder",
    )
    p.add_argument(
        "--ckpt-coding",
        default=None,
        metavar="mirror|erasure[:parity]",
        help="checkpoint replication byte-economy (exports "
        "$TPU_RESILIENCY_CKPT_CODING; workers building their replication "
        "strategy via checkpoint.coding.replication_from_env pick it up): "
        "'mirror' full-mirrors every shard across the clique (default), "
        "'erasure' stores one Reed-Solomon block per peer instead — "
        "~(1+(m-1)/k)x the payload on the wire per save vs (n-1)x",
    )
    p.add_argument(
        "--ckpt-delta-interval",
        type=int,
        default=None,
        metavar="N",
        help="delta-checkpoint cycle (exports $TPU_RESILIENCY_CKPT_DELTA): "
        "between full keyframes, up to N-1 replication rounds ship only the "
        "chunks whose manifest CRCs changed since the previous save; 0/1 "
        "disables (mirror strategy only)",
    )
    p.add_argument(
        "--cold-dir",
        default=None,
        metavar="DIR",
        help="durable cold tier root (exports $TPU_RESILIENCY_COLD_DIR; "
        "workers' LocalCheckpointManager picks it up via "
        "checkpoint.coldtier.cold_from_env): finalized keyframe containers "
        "are spilled there asynchronously — off the save critical path — "
        "and a FRESH job with an empty workdir can bootstrap from it on any "
        "world size. A dead/full backend degrades to local-only "
        "(coldtier_degraded events), never a failed save",
    )
    p.add_argument(
        "--cold-keep",
        type=int,
        default=None,
        metavar="N",
        help="cold-tier retention: keep the newest N archived iterations "
        "(exports $TPU_RESILIENCY_COLD_KEEP); pruning is keyframe-aware — "
        "an iteration a retained delta chain names as its base is never "
        "orphaned. Default: keep everything",
    )
    p.add_argument("--term-grace", type=float, default=15.0)
    p.add_argument("--log-dir", default=None, help="capture per-round/per-rank worker logs")
    p.add_argument(
        "--events-file",
        default=None,
        help="JSONL structured-event stream shared by the agent and every worker "
        "(exports $TPU_RESILIENCY_EVENTS_FILE; default: inherit the env var)",
    )
    p.add_argument(
        "--metrics-file",
        default=None,
        help="bridge events into per-process metrics JSON snapshots at this "
        "path, '<pid>' inserted before the extension (exports "
        "$TPU_RESILIENCY_METRICS_FILE); post-hoc aggregation needs only "
        "--events-file + tpu-metrics-dump",
    )
    p.add_argument(
        "--incidents-dir",
        default=None,
        help="enable the incident plane: incident-<ts>.json postmortem "
        "artifacts land here, and every process keeps a crash-surviving "
        "flight-recorder ring in the same directory (exports "
        "$TPU_RESILIENCY_FLIGHT_DIR); render artifacts with "
        "tpu-incident-report",
    )
    p.add_argument(
        "--telemetry-port",
        type=int,
        default=None,
        help="serve live job telemetry from the agent: /metrics (merged "
        "job-level Prometheus view from rank-pushed snapshots), /goodput "
        "(time-attribution ledger), /healthz (agent health decision). "
        "0 binds an ephemeral port; the bound port is written to "
        "<run-dir>/telemetry.port (omit the flag to disable)",
    )
    p.add_argument(
        "--fleet-dir",
        default=None,
        help="fleet-federation discovery directory shared by every job the "
        "fleet aggregator (tpu-fleetd) watches: the agent registers its "
        "telemetry endpoint there as a heartbeat-refreshed lease file "
        "(removed on clean exit, expired by fleetd on staleness) and stamps "
        "this job's --rdzv-id onto every event ($TPU_RESILIENCY_JOB) so "
        "fleet-merged streams slice back per job; implies --telemetry-port 0 "
        "when telemetry is not otherwise enabled",
    )
    p.add_argument(
        "--autoscale",
        choices=("off", "advise", "act"),
        default="off",
        help="goodput-optimal autoscale controller (launcher/autoscale.py): "
        "consumes the goodput ledger, straggler scores, warm-spare depth, "
        "and preemption notices (incl. rescinds) and picks the goodput-"
        "maximizing action from an explicit cost model. 'advise' (the safe "
        "mode to start with) audits every decision as autoscale_decision "
        "events + the /autoscale endpoint without acting; 'act' routes "
        "decisions through the remediation actuators and restart rounds",
    )
    p.add_argument(
        "--alerts",
        choices=("off", "on"),
        default="on",
        help="SLO watchtower (telemetry/watchtower.py): burn-rate and "
        "anomaly alert rules evaluated over in-process time-series rings "
        "fed from the shared events stream, served at GET /alerts and "
        "folded into /snapshot. Needs telemetry enabled to matter. Rule "
        "overrides via $TPU_RESILIENCY_ALERT_RULES (JSON file)",
    )
    p.add_argument("--run-dir", default="", help="scratch dir for sockets/error files")
    p.add_argument("--ft-cfg-path", default=None, help="YAML with a fault_tolerance section")
    p.add_argument("--no-ft-monitors", action="store_true", help="disable per-rank hang monitors")
    p.add_argument(
        "--no-python",
        action="store_true",
        help="run the script as a raw executable instead of through the interpreter",
    )
    p.add_argument(
        "--module",
        "-m",
        action="store_true",
        help="treat the positional as a python module (python -m NAME), "
        "reference --module",
    )
    p.add_argument("script", help="training script or module (plus its args)")
    p.add_argument("script_args", nargs=argparse.REMAINDER)
    return p


#: launcher flags that take no value — keep in sync with build_parser(); needed to
#: find where the user's script starts without invoking argparse
_STORE_TRUE_FLAGS = {
    "--store-auto-reshard",
    "--store-replicate",
    "--upscaling-enabled",
    "--no-ft-monitors",
    "--no-python",
    "--no-rdzv-fast-path",
    "--module",
    "-m",
    "--standalone",
    "-h",
    "--help",
}


def split_at_script(argv: list[str]) -> tuple[list[str], list[str]]:
    """Split argv into (launcher args, script + script args): the script is the
    first token that is neither an option nor an option's value."""
    i = 0
    while i < len(argv):
        a = argv[i]
        if a.startswith("-"):
            i += 1 if (a in _STORE_TRUE_FLAGS or "=" in a) else 2
        else:
            return argv[:i], argv[i:]
    return argv, []


def extract_ft_params(argv: list[str]) -> tuple[list[str], argparse.Namespace]:
    """Pull dynamic ``--ft-param-<field>[=| ]<value>`` options out of the *launcher's*
    portion of argv (reference's ``--ft-param-*`` namespace, ``config.py:144``).
    Tokens at or after the script name are left untouched — a ``--ft-param-*`` flag
    there belongs to the user's script, not to us."""
    head, tail = split_at_script(argv)
    rest: list[str] = []
    ns = argparse.Namespace()
    i = 0
    while i < len(head):
        arg = head[i]
        if arg.startswith("--ft-param-"):
            body = arg[len("--ft-param-") :]
            if "=" in body:
                name, value = body.split("=", 1)
            else:
                name = body
                i += 1
                if i >= len(head):
                    raise SystemExit(f"--ft-param-{name} requires a value")
                value = head[i]
            setattr(ns, f"ft_param_{name.replace('-', '_')}", value)
        else:
            rest.append(arg)
        i += 1
    return rest + tail, ns


def endpoint_is_local(host: str) -> bool:
    """Is the rendezvous endpoint this machine? Only then may we host the store —
    a free port elsewhere must NOT seed a second, split-brain store."""
    import socket as socketmod

    if host in ("", "localhost", "127.0.0.1", "0.0.0.0", "::1"):
        return True
    hostname = socketmod.gethostname()
    if host in (hostname, socketmod.getfqdn()):
        return True
    try:
        ep_ips = {ai[4][0] for ai in socketmod.getaddrinfo(host, None)}
    except OSError:
        return False
    local_ips = {"127.0.0.1", "::1"}
    try:
        local_ips |= {ai[4][0] for ai in socketmod.getaddrinfo(hostname, None)}
    except OSError:
        pass
    return bool(ep_ips & local_ips)


def host_or_connect_store(
    endpoint: str, rdzv_id: str = "default", store_shards: int = 1,
    store_replicate: bool = False,
):
    """Bind the KVServer on the endpoint port when the endpoint IS this machine and
    the port is free; otherwise connect as a client.

    First-local-agent-hosts: deterministic on one machine; in a multi-host job only
    agents on the endpoint host ever try to bind, so remote agents cannot form an
    isolated second store.

    ``store_shards > 1`` hosts a **clique** instead of one in-process server:
    N ``KVServer`` subprocesses (shard 0 on the endpoint port, the rest
    ephemeral), the spec exported via ``$TPU_RESILIENCY_STORE_SHARDS`` for
    every descendant and published on shard 0 under the reserved
    ``store-clique/endpoints`` key so late joiners handed only the classic
    endpoint reconnect as sharded clients instead of splitting the keyspace.
    Returns ``(store, server_or_clique_or_None, client_host, port)``; the
    store is a :class:`CoordStore` or a sharded
    :class:`~tpu_resiliency_torch.platform.shardstore.CliqueStore` — identical
    ``StoreView`` surface either way."""
    from tpu_resiliency_torch.exceptions import StoreError
    from tpu_resiliency_torch.platform.shardstore import (
        CLIQUE_KEY,
        REPLICATE_ENV,
        SHARDS_ENV,
        SpawnedClique,
        connect_store,
        probe_clique_spec,
    )

    host, _, port_s = endpoint.partition(":")
    port = int(port_s or "29511")
    auth_key = os.environ.get(AUTH_KEY_ENV) or None
    server = None
    client_host = host or "127.0.0.1"
    clique_spec = os.environ.get(SHARDS_ENV, "").strip()
    if not clique_spec and endpoint_is_local(host):
        # A live store already answering on the port (another job on this
        # shared endpoint, or an externally hosted server) means connect NOW —
        # entering the bind path would stall in its EADDRINUSE retry window
        # before falling back to client mode. Probe loopback first (job-hosted
        # stores bind it), then the endpoint's own address (an external server
        # may bind only the machine's non-loopback interface).
        probe_hosts = ["127.0.0.1"]
        if host and host not in ("127.0.0.1", "localhost", "0.0.0.0"):
            probe_hosts.append(host)
        live_host = next(
            (
                h
                for h in probe_hosts
                if port != 0 and store_answers(h, port, auth_key=auth_key)
            ),
            None,
        )
        if live_host is not None:
            log.info(f"live coordination store on {live_host}:{port}; joining as client")
            client_host = live_host
            clique_spec = probe_clique_spec(live_host, port, auth_key=auth_key)
        else:
            if store_shards > 1:
                try:
                    bind_host = "0.0.0.0" if auth_key else "127.0.0.1"
                    adv_host = (
                        host if host not in ("", "localhost", "0.0.0.0")
                        else "127.0.0.1"
                    )
                    server = SpawnedClique(
                        store_shards, host=bind_host, first_port=port,
                        advertise_host=adv_host if auth_key else "127.0.0.1",
                    )
                    port = server.port
                    client_host = "127.0.0.1"
                    clique_spec = server.spec
                    log.info(
                        f"hosting coordination store clique "
                        f"({store_shards} shards): {clique_spec}"
                    )
                except StoreError as e:
                    log.warning(
                        f"store clique spawn failed ({e}); falling back to a "
                        f"single in-process server"
                    )
                    server = None
            if server is None:
                try:
                    bind_host = "0.0.0.0" if auth_key else "127.0.0.1"
                    server = KVServer(host=bind_host, port=port, auth_key=auth_key)
                    port = server.port  # resolves port 0 → the ephemeral port actually bound
                    log.info(f"hosting coordination store on :{port}")
                    client_host = "127.0.0.1"
                except OSError:
                    client_host = "127.0.0.1"
    elif not clique_spec and port != 0:
        # Remote endpoint: one probe tells us whether it fronts a clique.
        clique_spec = probe_clique_spec(client_host, port, auth_key=auth_key)
    if clique_spec:
        # Every process we spawn (agents are in-process, workers/monitors
        # inherit the environment) must route through the same shard map.
        os.environ[SHARDS_ENV] = clique_spec
    if store_replicate and clique_spec:
        # Successor replication is a CLIENT-side discipline: descendants must
        # all double-write or the replica keyspace develops holes, so the
        # flag rides the environment the same way the shard spec does.
        os.environ[REPLICATE_ENV] = "1"
    # rdzv_id namespaces every launcher key: two jobs sharing one store server
    # never see each other's rendezvous/agent state (reference --rdzv-id).
    prefix = STORE_PREFIX + (f"{rdzv_id}/" if rdzv_id != "default" else "")
    store = connect_store(
        client_host, port, prefix=prefix, auth_key=auth_key, shards=clique_spec
    )
    if isinstance(server, SpawnedClique):
        # Publish the spec for late joiners (raw key on shard 0 — the clique
        # client routes CLIQUE_KEY wherever it hashes, so write it through a
        # direct shard-0 connection).
        shard0 = CoordStore(client_host, port, auth_key=auth_key)
        try:
            shard0.set(CLIQUE_KEY, clique_spec)
        finally:
            shard0.close()
    return store, server, client_host, port


def main(argv: Optional[list[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    argv, ft_ns = extract_ft_params(argv)
    args = build_parser().parse_args(argv)

    base_ft = (
        FaultToleranceConfig.from_yaml_file(args.ft_cfg_path)
        if args.ft_cfg_path
        else FaultToleranceConfig()
    )
    ft_cfg = FaultToleranceConfig.from_args(ft_ns, base=base_ft)

    # Flag validation first: reject before ANY side effects (env mutation,
    # store hosting).
    if args.fleet_dir:
        log.error(f"--fleet-dir: {unported('fleet_dir')}")
        return 2
    if args.module and args.no_python:
        log.error("--module and --no-python are mutually exclusive")
        return 2
    try:
        nnodes_spec = parse_nnodes(args.nnodes) if args.nnodes is not None else (1, 1)
    except ValueError:
        log.error(f"invalid --nnodes spec {args.nnodes!r}: want N or MIN:MAX")
        return 2
    if args.standalone:
        # Silently discarding an explicit endpoint would strand the other nodes
        # at a rendezvous this job never joins. Explicitness (not the literal
        # value) decides: typing the default endpoint still conflicts, while any
        # --nnodes spec meaning exactly one node ('1', '1:1') is consistent.
        if args.rdzv_endpoint is not None:
            log.error("--standalone conflicts with explicit --rdzv-endpoint")
            return 2
        if nnodes_spec != (1, 1):
            log.error("--standalone requires a single node (--nnodes 1)")
            return 2
    if args.rdzv_endpoint is None:
        args.rdzv_endpoint = "127.0.0.1:29511"
    if args.nnodes is None:
        args.nnodes = "1"

    if args.events_file:
        # One exported variable wires the whole tree: the agent records through it
        # and every spawned worker/monitor inherits it (events.py env sink).
        os.environ[EVENTS_FILE_ENV] = os.path.abspath(args.events_file)
    if args.fleet_dir:
        from tpu_resiliency_torch.utils.events import JOB_ENV

        # Fleet scope: stamp the job identity onto every event this process
        # tree records, so streams several jobs share (or fleetd later
        # merges) slice back to one job with --job.
        os.environ[JOB_ENV] = args.rdzv_id
    if args.metrics_file:
        os.environ[METRICS_FILE_ENV] = os.path.abspath(args.metrics_file)
    if args.ckpt_coding:
        from tpu_resiliency_torch.checkpoint.coding import CODING_ENV

        os.environ[CODING_ENV] = args.ckpt_coding
    if args.ckpt_delta_interval is not None:
        from tpu_resiliency_torch.checkpoint.coding.delta import DELTA_ENV

        os.environ[DELTA_ENV] = str(args.ckpt_delta_interval)
    if args.cold_dir:
        from tpu_resiliency_torch.checkpoint.coldtier import COLD_DIR_ENV, COLD_KEEP_ENV

        # One exported variable wires the whole tree, like the coding knobs:
        # every worker's LocalCheckpointManager builds its ColdTier from it
        # (checkpoint.coldtier.cold_from_env) — spills ride save-finalize,
        # restores grow the coverage ladder's cold rung.
        os.environ[COLD_DIR_ENV] = os.path.abspath(args.cold_dir)
        os.makedirs(os.path.abspath(args.cold_dir), exist_ok=True)
        if args.cold_keep is not None:
            os.environ[COLD_KEEP_ENV] = str(args.cold_keep)
    elif args.cold_keep is not None:
        log.warning("--cold-keep has no effect without --cold-dir")
    if args.compile_cache_dir:
        from tpu_resiliency_torch.platform import compile_cache

        cache_dir = os.path.abspath(args.compile_cache_dir)
        # Both exports on purpose: TPU_RESILIENCY_* drives this package's
        # integrity sweep + compile_cache event in workers that import it;
        # the compiler variables make workers that never import it cache too.
        # Sweep HERE, before any worker starts, so a cache corrupted between
        # jobs is purged exactly once up front.
        os.environ[compile_cache.CACHE_DIR_ENV] = cache_dir
        os.environ.update(compile_cache.compiler_cache_env(cache_dir))
        os.makedirs(cache_dir, exist_ok=True)
        swept = compile_cache.sweep(cache_dir)
        if swept.get("purged"):
            log.warning(
                f"compile cache sweep purged {swept['purged']} corrupt "
                f"entries from {cache_dir} (cold compiles will follow)"
            )
    # Trace identity rides the same single-export pattern: mint here (the root
    # of the process tree) so every agent/worker/monitor event shares one
    # trace_id and spans stitch cross-process (tools/trace_export.py).
    ensure_trace_id()

    if args.standalone:
        # Single-node convenience (reference --standalone): private ephemeral
        # store, one node — no rendezvous configuration needed.
        args.rdzv_endpoint = "127.0.0.1:0"
        args.nnodes = "1"
    min_nodes, max_nodes = parse_nnodes(args.nnodes)
    store, server, store_host, store_port = host_or_connect_store(
        args.rdzv_endpoint, rdzv_id=args.rdzv_id,
        store_shards=max(1, args.store_shards),
        store_replicate=bool(args.store_replicate),
    )
    # Cross-job registry OUTSIDE any rdzv-id namespace: which jobs are on this
    # endpoint. Powers the hosted-store teardown warning (a job-hosted server
    # dies with its job; other --rdzv-id jobs need to know why they lost it).
    import time as time_mod
    import uuid

    from tpu_resiliency_torch.platform.shardstore import connect_store as _connect_store

    jobs_reg = _connect_store(
        store_host, store_port, prefix="launcher-jobs/",
        auth_key=os.environ.get(AUTH_KEY_ENV) or None,
    )
    job_token = f"{args.rdzv_id}/{uuid.uuid4().hex[:8]}"
    try:
        jobs_reg.set(job_token, time_mod.time())
    except Exception:
        pass
    # Workers reach the store through the agent-visible address: if we host it,
    # that's this machine; remote workers of other agents use their agent's view.
    endpoint_host = args.rdzv_endpoint.partition(":")[0] or "127.0.0.1"
    worker_store_host = "127.0.0.1" if server is not None else endpoint_host

    worker_argv = [args.script] + list(args.script_args)
    if args.module:
        worker_argv = ["-m"] + worker_argv
    cfg = AgentConfig(
        argv=worker_argv,
        nproc_per_node=args.nproc_per_node,
        min_nodes=min_nodes,
        max_nodes=max_nodes,
        node_id=args.node_id,
        max_restarts=args.max_restarts,
        restart_policy=args.restart_policy,
        monitor_interval=args.monitor_interval,
        last_call_timeout=args.rdzv_last_call,
        keep_alive_interval=args.rdzv_keep_alive_interval,
        keep_alive_timeout=args.rdzv_keep_alive_timeout,
        upscaling_enabled=args.upscaling_enabled,
        term_grace=args.term_grace,
        run_dir=args.run_dir,
        log_dir=args.log_dir,
        use_python=not args.no_python,
        enable_ft_monitors=not args.no_ft_monitors,
        store_host=worker_store_host,
        store_port=store_port,
        warm_spares=args.warm_spares,
        warm_spare_preload=args.warm_spare_preload,
        warm_spare_warmup=args.warm_spare_warmup,
        rdzv_fast_path=not args.no_rdzv_fast_path,
        incidents_dir=(
            os.path.abspath(args.incidents_dir) if args.incidents_dir else ""
        ),
        telemetry_port=args.telemetry_port,
        fleet_dir=os.path.abspath(args.fleet_dir) if args.fleet_dir else "",
        job_id=args.rdzv_id,
        autoscale=args.autoscale,
        alerts=args.alerts,
        # rdzv-id namespacing keeps two jobs on one store endpoint from
        # merging each other's metrics snapshots into their /metrics views.
        metrics_push_prefix=f"jobmetrics/{args.rdzv_id}/",
    )
    agent = ElasticAgent(cfg, ft_cfg, store)
    auto_reshard = None
    if args.store_auto_reshard:
        from tpu_resiliency_torch.platform.shardstore import (
            AutoReshardSupervisor,
            CliqueStore,
            SpawnedClique,
        )

        if isinstance(server, SpawnedClique) and isinstance(store, CliqueStore):
            auto_reshard = AutoReshardSupervisor(server, store.client)
            auto_reshard.start()
            log.info(
                f"store auto-reshard supervisor watching "
                f"{len(server.endpoints)} shards"
            )
        else:
            log.warning(
                "--store-auto-reshard needs a job-hosted clique "
                "(--store-shards > 1); ignoring"
            )
    try:
        # The root span of the whole run: every round/rendezvous/worker span
        # parents (transitively) under it.
        with span("launcher", "launcher.job", node_id=cfg.node_id):
            exitcodes = agent.run()
        log.info(f"workload finished: exit codes {exitcodes}")
        return 0
    except WorkersFailed as e:
        log.error(f"workload failed: {e}")
        return 1
    finally:
        if auto_reshard is not None:
            auto_reshard.stop()
        if server is not None:
            # We host the control plane: closing it while peers still coordinate
            # would rip the store out from under them — wait for their exit marks.
            try:
                agent.rdzv.await_peers_exit()
            except Exception:
                pass
            # An in-process-hosted store dies with this job (same lifetime as
            # torchrun's agent-hosted c10d store). Other --rdzv-id jobs on this
            # endpoint cannot hold us open — warn so their failures aren't
            # mysterious; host the store externally
            # (python -m tpu_resiliency_torch.platform.store) for multi-job endpoints.
            try:
                foreign = {
                    k.split("/")[0]
                    for k in jobs_reg.prefix_get("")
                    if not k.startswith(f"{args.rdzv_id}/")
                }
                if foreign:
                    log.warning(
                        f"closing the job-hosted store with other rdzv-id jobs "
                        f"still registered ({sorted(foreign)[:5]}); host the "
                        f"store externally to outlive this job"
                    )
            except Exception:
                pass
        try:
            jobs_reg.delete(job_token)
        except Exception:
            pass
        jobs_reg.close()
        store.close()
        if server is not None:
            server.close()


if __name__ == "__main__":
    sys.exit(main())
