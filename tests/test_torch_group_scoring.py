"""The port's process-group scoring held against the JAX package's single-program
scoring on the whole matrix, in 2 and 4 gloo processes on the CPU.

Each child process holds one block of ranks: ``score_round(group=...)`` on its rows
(sort path and the ``loop`` kernel's plain version), ``MeshTelemetry(group=...)``
over the ring (two reports, the second after the ring wrapped) and over summaries
(``score_local_summary`` / ``report_from_summary``, two rounds). Rank 0's gathered
scores and every rank's reports are held against
``tpu_resiliency.telemetry.scoring.score_round`` on the full matrix: masks exactly,
scores within ``tests/test_torch_scoring.py``'s ``TOL``. Then the port's ``Detector``
takes its group path over 2 processes with a ``CoordStore``, and no per-rank
summary key may reach the store (the assertion of
``tests/telemetry/test_mesh_multiprocess.py``).

Children use a free localhost port, and each is joined with its own timeout of
120 s, then killed, and the test fails.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from tests.test_torch_scoring import TOL
from tpu_resiliency.platform.store import KVServer
from tpu_resiliency.telemetry import scoring as ref_scoring

REPO_ROOT = Path(__file__).resolve().parent.parent
CHILD_TIMEOUT_S = 120
R, S, W = 16, 6, 8

GEN = textwrap.dedent(
    '''
    import numpy as np

    def windows(seed, r, s, w):
        """[R, S, W] gamma timings, slow ranks 3 and 12, a partially observed signal,
        a signal nobody measured and a rank that missed one signal."""
        rng = np.random.default_rng(seed)
        data = rng.gamma(4.0, 0.01, size=(r, s, w)).astype(np.float32)
        data[[3, 12]] *= 1.8
        counts = np.full((r, s), w, dtype=np.int32)
        counts[:, s - 2] = rng.integers(1, w + 1, size=r)
        counts[:, s - 1] = 0
        counts[1, 0] = 0
        return data, counts

    def summaries(seed, r, s):
        """[R, S] medians, weights and counts of one summary round."""
        rng = np.random.default_rng(seed)
        med = rng.gamma(4.0, 0.01, size=(r, s)).astype(np.float32)
        med[3] *= 2.0
        cnt = rng.integers(0, 5, size=(r, s)).astype(np.int32)
        wgt = (med * np.maximum(cnt, 1)).astype(np.float32)
        med[cnt == 0] = np.inf
        return med, wgt, cnt

    def ring_rows(seed, n, r, s):
        """``n`` step rows [R, S]: a homogeneous fleet with 3% jitter, rank 5 3x slow."""
        rng = np.random.default_rng(seed)
        base = rng.gamma(4.0, 0.01, size=(1, 1, s))
        rows = (base * rng.uniform(0.97, 1.03, size=(n, r, s))).astype(np.float32)
        rows[:, 5] *= 3.0
        return rows
    '''
)

CHILD = GEN + textwrap.dedent(
    '''
    import sys
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    from tpu_resiliency_torch.telemetry import scoring
    from tpu_resiliency_torch.telemetry.sharded import MeshTelemetry
    from tpu_resiliency_torch.ops.scoring_kernels import fused_median_weights

    rank, world, port, out = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    R, S, W = (int(x) for x in sys.argv[5:8])
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world, timeout=timedelta(seconds=60))
    group = dist.group.WORLD
    L = R // world
    rows = slice(rank * L, (rank + 1) * L)
    res = {}

    def keep(prefix, sc):
        full = scoring.scores_to_host(scoring.gather_scores(sc, group))
        for name in scoring._FIELDS:
            res[f"{prefix}/{name}"] = getattr(full, name)

    def keep_report(prefix, rep):
        res[f"{prefix}/perf"] = np.array([rep.perf_scores[r] for r in range(R)])
        res[f"{prefix}/z"] = np.array([rep.z_scores[r] for r in range(R)])
        res[f"{prefix}/ewma"] = np.array([rep.ewma_scores[r] for r in range(R)])
        res[f"{prefix}/section"] = rep.global_section_scores
        res[f"{prefix}/by_perf"] = np.array(sorted(s.rank for s in rep.identify_stragglers().by_perf))
        res[f"{prefix}/world"] = np.array(rep.world_size)

    data, counts = windows(1, R, S, W)
    d, c = torch.from_numpy(data[rows]), torch.from_numpy(counts[rows])
    ewma, hist = torch.ones(L), torch.full((L, S), float("inf"))
    keep("round", scoring.score_round(d, c, ewma, hist, group=group))
    keep("round_kernel", scoring.score_round(d, c, ewma, hist, group=group,
                                             medians_and_weights=fused_median_weights(d, c)))

    mt = MeshTelemetry(R, signal_names=tuple(f"s{i}" for i in range(S)), window=W,
                       group=group, device="cpu")
    assert mt.local_ranks == L
    for k in range(2):
        med, wgt, cnt = summaries(10 + k, R, S)
        keep_report(f"summary{k}", mt.report_from_summary(med[rows], wgt[rows], cnt[rows],
                                                          rank=rank))

    mt = MeshTelemetry(R, signal_names=tuple(f"s{i}" for i in range(S)), window=W,
                       group=group, device="cpu")
    state = mt.init_state()
    ring = ring_rows(20, 2 * W + 3, R, S)
    for k, (a, b) in enumerate(((0, W), (W, 2 * W + 3))):  # the second wraps the ring
        for i in range(a, b):
            mt.push(state, torch.from_numpy(ring[i, rows]))
        state, rep = mt.generate_report(state, rank=rank)
        keep_report(f"ring{k}", rep)
    np.savez(out, **res)
    dist.destroy_process_group()
    '''
)

DETECTOR_CHILD = textwrap.dedent(
    '''
    import json, sys
    from datetime import timedelta

    import numpy as np
    import torch.distributed as dist

    from tpu_resiliency.platform.store import CoordStore
    from tpu_resiliency_torch.telemetry.detector import Detector
    from tpu_resiliency_torch.telemetry.sharded import MeshTelemetry

    rank, kv_port, port = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=2, timeout=timedelta(seconds=60))
    mt = MeshTelemetry(2, signal_names=tuple(f"c{i}" for i in range(8)),
                       group=dist.group.WORLD, device="cpu")
    store = CoordStore("127.0.0.1", kv_port, timeout=60.0)
    Detector.initialize(rank=rank, world_size=2, store=store, gather_on_rank0=False,
                        report_time_interval=3600.0, device_telemetry=mt, device="cpu")
    rng = np.random.default_rng(rank)
    out = {"rank": rank, "rounds": []}
    for k in range(2):
        step = (0.02 if rank == 1 else 0.005) * rng.uniform(0.95, 1.05, 6)
        Detector.record_program_samples({"fwd": list(0.004 * rng.uniform(0.95, 1.05, 6))})
        Detector._record_samples("sec/", {"step": list(step)})
        if k == 0:
            Detector._record_samples("sec/", {"io": list(0.004 * rng.uniform(0.95, 1.05, 4))})
        summary = Detector.local_summary()
        report = Detector.generate_report()
        assert report is not None
        leaked = store.prefix_get("telemetry/round/")
        assert leaked == {}, f"summary gather leaked through the store: {leaked}"
        out["rounds"].append({
            "summary": summary,
            "sections": list(report.section_names),
            "perf": [report.perf_scores[r] for r in range(2)],
            "ewma": [report.ewma_scores[r] for r in range(2)],
            "by_perf": sorted(s.rank for s in report.identify_stragglers().by_perf),
        })
    assert Detector._mesh_telemetry is mt  # never fell back to the store path
    Detector.shutdown()
    store.close()
    dist.destroy_process_group()
    print("RESULT " + json.dumps(out), flush=True)
    '''
)

exec(GEN)  # windows, summaries, ring_rows: the children's data, here for the reference


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_children(script: Path, argv_of, world: int, cwd: Path):
    """Start ``world`` children, join each with its own timeout, kill on expiry.
    Returns their stdouts; fails if any timed out or exited non-zero."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (str(REPO_ROOT), env.get("PYTHONPATH")) if p)
    procs = [
        subprocess.Popen([sys.executable, str(script), *map(str, argv_of(r))], cwd=cwd, env=env,
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)
    ]
    outs, failures = [], []
    try:
        for r, p in enumerate(procs):
            try:
                out, err = p.communicate(timeout=CHILD_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                p.kill()
                out, err = p.communicate()
                failures.append(f"rank {r} timed out after {CHILD_TIMEOUT_S} s:\n{err[-3000:]}")
                continue
            if p.returncode != 0:
                failures.append(f"rank {r} exited {p.returncode}:\n{err[-3000:]}")
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert not failures, "\n".join(failures)
    return outs


@pytest.fixture(scope="module", params=[2, 4], ids=["2proc", "4proc"])
def group_results(request, tmp_path_factory):
    world = request.param
    tmp = tmp_path_factory.mktemp(f"group{world}")
    script = tmp / "child.py"
    script.write_text(CHILD)
    port = free_port()
    run_children(script, lambda r: (r, world, port, tmp / f"rank{r}.npz", R, S, W), world, tmp)
    return world, [dict(np.load(tmp / f"rank{r}.npz")) for r in range(world)]


def reference_round(data, counts, ewma, hist, mw=None):
    return ref_scoring.score_round(
        jnp.asarray(data), jnp.asarray(counts), jnp.asarray(ewma), jnp.asarray(hist),
        medians_and_weights=mw,
    )


def reference_summary(med, wgt, cnt, ewma, hist):
    return reference_round(np.zeros(med.shape + (1,), np.float32), cnt, ewma, hist,
                           mw=(jnp.asarray(med), jnp.asarray(wgt)))


def assert_fields_match(res, prefix, ref):
    for name, tol in TOL.items():
        np.testing.assert_allclose(res[f"{prefix}/{name}"], np.asarray(getattr(ref, name)),
                                   err_msg=name, **tol)
    np.testing.assert_array_equal(res[f"{prefix}/straggler"], np.asarray(ref.straggler))


def assert_report_matches(res, prefix, ref):
    for key, name in (("perf", "perf"), ("z", "z"), ("ewma", "ewma")):
        np.testing.assert_allclose(res[f"{prefix}/{key}"], np.asarray(getattr(ref, name)),
                                   err_msg=f"{prefix} {key}", **TOL[name])
    np.testing.assert_allclose(res[f"{prefix}/section"], np.asarray(ref.section_scores),
                               **TOL["section_scores"])
    assert int(res[f"{prefix}/world"]) == R


def flagged(perf, z):
    return sorted(int(r) for r in np.flatnonzero((np.asarray(perf) < 0.75) | (np.asarray(z) < -3.0)))


@pytest.mark.parametrize("prefix", ["round", "round_kernel"])
def test_score_round_over_a_group_matches_the_whole_matrix(group_results, prefix):
    _, ranks = group_results
    data, counts = windows(1, R, S, W)
    ref = reference_round(data, counts, np.ones(R, np.float32), np.full((R, S), np.inf, np.float32))
    for res in ranks:  # every process gathers the same full rows
        assert_fields_match(res, prefix, ref)
    assert bool(np.asarray(ref.straggler)[[3, 12]].all())


def test_report_from_summary_over_a_group_matches_the_whole_matrix(group_results):
    _, ranks = group_results
    ewma, hist = np.ones(R, np.float32), np.full((R, S), np.inf, np.float32)
    for k in range(2):
        med, wgt, cnt = summaries(10 + k, R, S)
        ref = reference_summary(med, wgt, cnt, ewma, hist)
        ewma, hist = np.asarray(ref.ewma), np.asarray(ref.historical_min)
        for res in ranks:
            assert_report_matches(res, f"summary{k}", ref)
            assert list(res[f"summary{k}/by_perf"]) == flagged(ref.perf, ref.z)


def test_ring_reports_over_a_group_match_the_whole_matrix(group_results):
    _, ranks = group_results
    ring = ring_rows(20, 2 * W + 3, R, S)
    ewma, hist = np.ones(R, np.float32), np.full((R, S), np.inf, np.float32)
    buf = np.zeros((W, R, S), np.float32)
    for k, (a, b) in enumerate(((0, W), (W, 2 * W + 3))):
        for i in range(a, b):
            buf[(i - a) % W] = ring[i]  # each report scores the rows since the last
        data = np.transpose(buf, (1, 2, 0)).copy()
        counts = np.full((R, S), min(b - a, W), np.int32)
        ref = reference_round(data, counts, ewma, hist)
        ewma, hist = np.asarray(ref.ewma), np.asarray(ref.historical_min)
        for res in ranks:
            assert_report_matches(res, f"ring{k}", ref)
            assert list(res[f"ring{k}/by_perf"]) == flagged(ref.perf, ref.z)
            assert 5 in res[f"ring{k}/by_perf"]


def test_detector_group_path_sends_no_summary_through_the_store(tmp_path):
    script = tmp_path / "detector_child.py"
    script.write_text(DETECTOR_CHILD)
    kv = KVServer(host="127.0.0.1", port=0)
    port = free_port()
    try:
        outs = run_children(script, lambda r: (r, kv.port, port), 2, tmp_path)
    finally:
        kv.close()
    results = {}
    for out in outs:
        line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")][0]
        r = json.loads(line[len("RESULT "):])
        results[r["rank"]] = r
    ewma, hist = np.ones(2, np.float32), np.full((2, 8), np.inf, np.float32)
    for k in range(2):
        rounds = [results[r]["rounds"][k] for r in range(2)]
        names = rounds[0]["sections"]
        assert rounds[1]["sections"] == names == ["prog/fwd", "sec/io", "sec/step"]
        # The reference: the whole [2, 8] summary matrix in the agreed column order.
        med = np.full((2, 8), np.inf, np.float32)
        wgt = np.zeros((2, 8), np.float32)
        cnt = np.zeros((2, 8), np.int32)
        for r in range(2):
            for j, n in enumerate(names):
                st = rounds[r]["summary"].get(n)
                if st:
                    med[r, j], wgt[r, j], cnt[r, j] = st["median"], st["total"], st["count"]
        ref = reference_summary(med, wgt, cnt, ewma, hist)
        ewma, hist = np.asarray(ref.ewma), np.asarray(ref.historical_min)
        for rd in rounds:  # both processes hold the same global view
            np.testing.assert_allclose(rd["perf"], np.asarray(ref.perf), **TOL["perf"])
            np.testing.assert_allclose(rd["ewma"], np.asarray(ref.ewma), **TOL["ewma"])
            assert rd["by_perf"] == flagged(ref.perf, ref.z) == [1]
