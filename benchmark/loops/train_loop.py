"""Train steps under the straggler stack: the program's train loop as a user runs it.

``run_training`` drives the program's ``make_train_step`` (AdamW over float32
weights, the configuration's compute type) on seeded token batches, with the
program's ``StragglerDetectionCallback`` attached as the mix sets it (profiled steps,
per-kernel signals, time-based reports). The loop reads each step's loss, as a
training loop logs it. One rank of a one-rank job: no rows of absent ranks are made.

Set-up builds the model and optimizer once and runs the first steps through the same
loop, callback and feed as the window, then the window continues the same loop.

End to end: every token of every step completed in the window over the window. The
comparison with the plain reference, after the window: the first steps' losses, each
leaf's first gradient (from the optimizer's first moment after one step), each leaf's
change over the compared steps, and every straggler report of the window. The callback
is held to what the mix asks of it: no hook raises (the loop's runner would log it and
go on), every profiled step of the window hands the detector its kernels' device
times, and every report of the window carries the kernel signals and times each step
as the benchmark's own clock does.
"""

from __future__ import annotations

import contextlib
import statistics
import sys
import time

import torch

from benchmark import generator
from benchmark.checks import Checks
from benchmark.outcome import Outcome
from benchmark.reference import mistral, scorer

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def program_config(cfg: dict, seq: int):
    from tpu_resiliency_torch.models.transformer import TransformerConfig

    if cfg["rms_norm_eps"] != 1e-5 or cfg["hidden_act"] != "silu" or cfg["tie_word_embeddings"]:
        raise ValueError("the program's decoder has RMSNorm eps 1e-5, SiLU gates and an "
                         "untied head only")
    if cfg.get("sliding_window") and cfg["sliding_window"] < seq:
        raise ValueError("sequences longer than the sliding window need windowed attention")
    return TransformerConfig(
        vocab_size=cfg["vocab_size"], d_model=cfg["hidden_size"],
        n_layers=cfg["num_hidden_layers"], n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"], d_ff=cfg["intermediate_size"],
        max_seq_len=seq, rope_theta=cfg["rope_theta"], dtype=DTYPES[cfg["torch_dtype"]],
    )


class Timed:
    """Wraps the program's callback and passes every hook on. It keeps the host time
    inside the step hooks while ``counting`` (up to the raise, where a hook raises),
    every exception a hook raises, and every report the callback hands over, with
    the step it came at."""

    def __init__(self, inner, tracer):
        self.inner, self.tracer = inner, tracer
        self.counting = False
        self.seconds = 0.0
        self.errors: list[str] = []
        self.reports: list = []  # (step, report)

    def __getattr__(self, hook: str):
        from tpu_resiliency_torch.integrations.loop import StopTraining

        call = getattr(self.inner, hook)
        if not hook.startswith("on_"):
            return call

        def timed(ctx, *args):
            before = self.inner.last_report
            t0 = time.perf_counter()
            try:
                with self.tracer.region("callback"):
                    call(ctx, *args)
            except StopTraining:
                raise
            except Exception as exc:
                self.errors.append(f"{hook} at step {ctx.step}: {exc!r}")
                raise
            finally:
                if self.counting and hook in ("on_step_start", "on_step_end"):
                    self.seconds += time.perf_counter() - t0
                if self.inner.last_report is not before:
                    self.reports.append((ctx.step, self.inner.last_report))

        return timed


@contextlib.contextmanager
def spying(owner, name: str, sink):
    """Passes every call of the class's method ``name`` on, and hands its arguments
    and result to ``sink``; puts the method back on leaving."""
    raw, bound = owner.__dict__[name], getattr(owner, name)

    def spy(*args, **kw):
        out = bound(*args, **kw)
        sink(args, out)
        return out

    setattr(owner, name, staticmethod(spy))
    try:
        yield
    finally:
        setattr(owner, name, raw)


def leaf_norms(tensors) -> dict[str, float]:
    return {k: float(v.float().norm()) for k, v in tensors}


def first_gradient_norms(model, opt, beta1: float) -> tuple[dict, dict]:
    """Each leaf's first gradient as the optimizer got it, from its first moment after
    one step (``(1 - beta1) * g``): its norm and its largest magnitude. A leaf the
    optimizer never updated reads 0."""
    norms, largest = {}, {}
    for name, p in model.named_parameters():
        m = opt.state.get(p, {}).get("exp_avg")
        norms[name] = 0.0 if m is None else float(m.float().norm()) / (1 - beta1)
        largest[name] = 0.0 if m is None else float(m.float().abs().amax()) / (1 - beta1)
    return norms, largest


def run(cell, seed: int, seconds: float, tracer, device) -> Outcome:
    from tpu_resiliency_torch.integrations import loop, straggler_callback
    from tpu_resiliency_torch.models import transformer
    from tpu_resiliency_torch.telemetry import detector
    from tpu_resiliency_torch.telemetry.detector import Detector

    cfg, mix = cell.config, cell.traffic
    seq, batch = cfg["assumed"]["seq_len"], cfg["assumed"]["micro_batch"]
    opt_cfg = cfg["assumed"]["optimizer"]
    cuda = torch.device(device).type == "cuda"
    compared, warmup = mix["compared_steps"], mix["warmup_steps"]
    every = mix["profile_programs_every"]
    traced = range(warmup + mix["trace_skip"], warmup + mix["trace_skip"] + mix["trace_steps"])
    if any(i % every == 0 for i in traced):
        raise ValueError("the traced steps must not hold one of the callback's profiled steps")

    model = transformer.Transformer(program_config(cfg, seq),
                                    params=generator.decoder_weights(cfg, seed, device))
    train_step, init_opt = transformer.make_train_step(
        program_config(cfg, seq),
        optimizer=transformer.adamw(lr=opt_cfg["lr"], weight_decay=opt_cfg["weight_decay"]))
    opt = init_opt(model)
    batches = generator.TokenBatches(cfg, batch, seq, seed, device)
    callback = Timed(straggler_callback.StragglerDetectionCallback(
        report_time_interval=mix["report_time_interval_s"], use_kernel=mix["use_kernel"],
        profile_programs_every=every, profile_ops=mix["profile_ops"],
        max_signals=mix["max_signals"], device=device), tracer)
    losses, first_grads, first_max, changes, clock = [], {}, {}, {}, {}
    spans, ops, summaries = {}, {}, {}  # by step

    def step(state, i):
        clock["step"] = i
        t0 = time.perf_counter()
        with tracer.region("step"):
            _, _, loss = train_step(model, opt, batches.next())
            value = float(loss)  # the loop's loss read
        spans[i] = time.perf_counter() - t0
        if i < compared:
            losses.append(value)
        return state

    def op_samples(args, _):
        seconds, count = ops.get(clock["step"], (0.0, 0))
        for times in args[0].values():
            seconds, count = seconds + sum(times), count + len(times)
        ops[clock["step"]] = (seconds, count)

    class Window(loop.Callback):
        """Closes the set-up after ``warmup`` steps and the window at its deadline;
        reads the compared state in set-up. The deadline comes first: the loop's
        callback runner logs what a hook raises and goes on."""

        def on_step_start(self, ctx):
            if ctx.step == traced.start:
                tracer.start()

        def on_step_end(self, ctx):
            i = ctx.step
            if i >= warmup:
                if "start" not in clock:  # the set-up's last hook failed: no window
                    ctx.should_stop = True
                elif time.perf_counter() - clock["start"] >= seconds:
                    clock["end"], clock["steps"] = time.perf_counter(), i - warmup + 1
                    ctx.should_stop = True
            if i == traced.stop - 1:
                tracer.stop()
            if i == 0:
                norms, largest = first_gradient_norms(model, opt, opt_cfg["betas"][0])
                first_grads.update(norms)
                first_max.update(largest)
            if i == compared - 1:
                start = generator.decoder_weights(cfg, seed, device)
                changes.update(leaf_norms((n, p.detach() - start[n])
                                          for n, p in model.named_parameters()))
                del start
            if i == warmup - 1:
                if cuda:
                    torch.cuda.synchronize(device)
                clock["wall"], clock["start"] = time.time(), time.perf_counter()
                callback.counting = True

    with spying(Detector, "record_op_samples", op_samples), \
            spying(Detector, "local_summary",
                   lambda _, out: summaries.__setitem__(clock["step"], out)):
        ctx = loop.run_training(step, None, 1 << 62, callbacks=[callback, Window()],
                                ctx=loop.LoopContext(rank=0, world_size=1))
    if "end" not in clock:
        raise RuntimeError(f"the loop stopped at step {ctx.step} before the window closed")
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    window_s = clock["end"] - clock["start"]
    tokens = batch * seq * clock["steps"]
    callback_s = callback.seconds
    window = range(warmup, warmup + clock["steps"])
    section = detector.SECTION_PREFIX + callback.inner.section_name
    reports = [(i, r) for i, r in callback.reports if i in window]
    checks = Checks(cell.limits)
    check_callback(checks, callback.errors, [i for i in window if i % every == 0], ops,
                   spans, callback.reports, summaries, section, window,
                   detector.OP_PREFIX, one_stream=cuda)
    del model, opt, train_step, callback
    if cuda:
        torch.cuda.empty_cache()

    if cuda:
        mistral.full_precision()
    ref_batches = generator.TokenBatches(cfg, batch, seq, seed, device)
    ref = mistral.train(cfg, opt_cfg, generator.decoder_weights(cfg, seed, device),
                        [ref_batches.next() for _ in range(compared)])
    compare_training(checks, {"losses": losses, "grad_norms": first_grads,
                              "grad_max": first_max, "change_norms": changes}, ref)
    checks.add("reports_missing", int(not reports))
    checks.add("report_mismatches", sum(report_mismatches(r, cell.config) for _, r in reports))
    return Outcome(
        window_start=clock["wall"],
        end_to_end={"tokens_per_s": tokens / window_s},
        counters={"steps": clock["steps"], "tokens": tokens, "window_s": window_s,
                  "callback_s": callback_s,
                  "reports": len(reports)},
        checks=checks.results(),
        attempted=clock["steps"],
        failed=0,
        memory_peak_bytes=peak,
    )


def check_callback(checks: Checks, errors: list, profiled: list, ops: dict, spans: dict,
                   reports: list, summaries: dict, section: str, window: range,
                   op_prefix: str, one_stream: bool) -> None:
    """The callback against what the mix asks of it and the benchmark's own clock:

    - ``callback_errors``: exceptions its hooks raised, in set-up or in the window;
    - ``profiled_steps_missing``: profiled steps of the window that handed the
      detector no kernel times, or, on the card (``one_stream``), kernel times that sum
      to more than twice the step's own span (a step's kernels run on one stream, and
      overlap at most where a dependent launch starts early); the CPU's host operators
      nest, so there the times only have to be there;
    - ``report_section_errors``: reports of the window without the summary they were
      built from, without kernel signals, or whose step section counts other steps
      than those since the report before;
    - ``section_time_gap``: the worst report's median step section against the
      median of the benchmark's own spans of the same steps.
    """
    for e in errors:
        print(f"callback raised: {e}", file=sys.stderr)
    checks.add("callback_errors", len(errors))
    share = {i: ops[i][0] / spans[i] for i in profiled if ops.get(i, (0.0, 0))[1] > 0}
    missing = [i for i in profiled
               if not (0 < share.get(i, 0) and (share[i] <= 2 or not one_stream))]
    print("profiled steps of the window (kernels, their seconds over the step's span): "
          f"{ {i: (ops.get(i, (0.0, 0))[1], share.get(i)) for i in profiled} }; "
          f"missing: {missing}", file=sys.stderr)
    checks.add("profiled_steps_missing", len(missing))
    bad, worst, last = 0, 0.0, -1
    for i, report in reports:
        steps = range(last + 1, i + 1)
        last = i
        if i not in window:
            continue
        stats = summaries.get(i, {}).get(section)
        has_ops = any(n.startswith(op_prefix) for n in report.section_names)
        if stats is None or not has_ops or stats["count"] != len(steps):
            print(f"report at step {i}: section {stats}, {len(steps)} steps, kernel "
                  f"signals {has_ops}", file=sys.stderr)
            bad += 1
            continue
        own = statistics.median(spans[j] for j in steps)
        worst = max(worst, abs(stats["median"] / own - 1))
    checks.add("report_section_errors", bad)
    checks.add("section_time_gap", worst)


def gaps(program: dict, reference: dict, keep=None) -> dict[str, float]:
    """Each leaf's gap of norms, ``|program - reference|`` over the larger of the
    reference's norm of that leaf and of the median leaf."""
    names = [k for k in reference if keep is None or keep(k)]
    median = statistics.median(reference[k] for k in names)
    return {k: abs(program[k] - reference[k]) / max(reference[k], median) for k in names}


def worst(name: str, by_leaf: dict[str, float]) -> float:
    leaf = max(by_leaf, key=by_leaf.get)
    detail = ", ".join(f"{k} {v:.3e}" for k, v in sorted(by_leaf.items()))
    print(f"{name}: worst leaf {leaf} {by_leaf[leaf]!r} ({detail})", file=sys.stderr)
    return by_leaf[leaf]


def training_numbers(program: dict, ref: dict) -> dict[str, float]:
    """The compared numbers of the first steps: the worst step's relative loss gap, the
    worst leaf's gap of the first gradient's norm and of its largest magnitude, and of
    the change's norm over the steps."""
    by_step = [abs(a - b) / abs(b) for a, b in zip(program["losses"], ref["losses"],
                                                   strict=True)]
    print(f"loss_rel_err by step: {by_step!r}", file=sys.stderr)
    # A leaf whose reference gradient is nought to rounding moves by round-off alone.
    floor = 1e-3 * statistics.median(ref["grad_norms"].values())
    return {
        "loss_rel_err": max(by_step),
        "first_grad_gap": worst("first_grad_gap", gaps(program["grad_norms"],
                                                       ref["grad_norms"])),
        "first_grad_max_gap": worst("first_grad_max_gap", gaps(program["grad_max"],
                                                               ref["grad_max"])),
        "change_gap": worst("change_gap", gaps(program["change_norms"], ref["change_norms"],
                                               keep=lambda k: ref["grad_norms"][k] >= floor)),
    }


def compare_training(checks: Checks, program: dict, ref: dict) -> None:
    for name, value in training_numbers(program, ref).items():
        if name in checks.limits:
            checks.add(name, value)


def report_mismatches(report, cfg: dict) -> int:
    """Values of a one-rank straggler report that differ from the plain scorer's
    round over one rank (any positive medians and totals give the same)."""
    signals = len(report.section_names)
    ref = scorer.Scorer(cfg["straggler_scoring"], 1, signals, "cpu").round(
        torch.ones(1, signals), torch.ones(1, signals))
    flagged = report.identify_stragglers(
        perf_threshold=cfg["straggler_scoring"]["threshold"],
        section_threshold=cfg["straggler_scoring"]["threshold"],
        z_threshold=cfg["straggler_scoring"]["z_threshold"])
    got = (report.perf_scores[0], report.z_scores[0], report.ewma_scores[0],
           bool(flagged.by_perf))
    want = (float(ref.perf[0]), float(ref.z[0]), float(ref.ewma[0]), bool(ref.flagged[0]))
    return sum(a != b for a, b in zip(got, want))
