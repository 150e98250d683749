"""One run of one cell: set-up through the port's CLI code, round 0, the
rounds up to the cell's ``check_round`` (that one recorded for the check,
its copies on the host), the timed window of client-parallel rounds, an
optional traced tail, one more round recorded after them, then the
comparison with the plain reference.

The window drives the same calls in the same order as the FedOTPLoRA branch
of ``fairfedmed_tpu_torch/federated_main.py:main`` under
``--parallel_clients``: round r is dispatched (``run_round(...,
deferred=True)``), then round r-1 is flushed (``resolve_round``, then
``parallel_eval`` and the printed summary), clients drawn by ``_pick_users``.
Whole rounds run back to back until the window's seconds have passed, then
the last round is flushed.  ``round_s`` is the window's wall time over its
rounds.
"""

from __future__ import annotations

import contextlib
import gc
import math
import os
import shutil
import sys
import time

import numpy as np
import torch

from . import check, inputs, spec
from .reference import model as ref
from .timeline import reduce_trace

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "fairfedmed_tpu")
SEED_MODULUS = 2 ** 31  # the port's --seed seeds numpy's global stream, which takes 32 bits


class Run:
    """What a run measured, as the per-layer readers see it."""

    def __init__(self, cell: spec.Cell, batch_size: int, eval_batch_size: int):
        self.config, self.traffic = cell.config, cell.traffic
        self.batch_size, self.eval_batch_size = batch_size, eval_batch_size
        self.rounds = []  # the window's rounds: host spans, steps, evaluation sizes
        self.traced_rounds = []  # the same of the rounds under the profiler
        self.trace = None  # timeline.TraceView of the traced rounds
        self.setup_s = self.round0_s = self.window_s = None
        self.n_rounds = self.failed = self.peak = 0
        self.parts, self.readings = {}, {}


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _span(name):
    return torch.profiler.record_function(f"bench:{name}")


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build_argv(cell: spec.Cell, root: str, out_dir: str, seed: int) -> list:
    """The launcher's flags with the run's overrides: data root, output
    directory, seed, the configuration's and the traffic's flags."""
    argv = inputs.launcher_flags(str(spec.REPO / cell.config["launcher"]))
    for flag, value in {"--root": root, "--output-dir": out_dir,
                        "--seed": str(seed % SEED_MODULUS), **cell.config["flags"],
                        **cell.traffic["flags"]}.items():
        argv = inputs.set_flag(argv, flag, value)
    for flag in ("--config-file", "--dataset-config-file"):
        i = argv.index(flag)
        argv[i + 1] = str(spec.REPO / argv[i + 1])
    return argv + list(cell.config.get("opts", []))


def check_program_config(cfg, args, trainer, cell: spec.Cell) -> None:
    """Raise where the program would not run the method the configuration
    states."""
    m, o = cell.config["method"], cell.config["optim"]
    want = {
        "backbone": (cfg.MODEL.BACKBONE.NAME, cell.config["backbone"]),
        "trainer": (cfg.TRAINER.NAME, m["trainer"]), "model": (args.model, m["model"]),
        "OT": (cfg.TRAINER.GLP_OT.OT, m["OT"]), "PREC": (cfg.TRAINER.GLP_OT.PREC, m["prec"]),
        "n_ctx": (cfg.TRAINER.GLP_OT.N_CTX, m["n_ctx"]), "num_prompt": (cfg.TRAINER.GLP_OT.N, m["num_prompt"]),
        "lora_type": (cfg.TRAINER.GLP_OT_LORA.TYPE, m["lora_type"]),
        "lora_rank": (cfg.TRAINER.GLP_OT_LORA.RANK, m["lora_rank"]),
        "lora_alpha": (cfg.TRAINER.GLP_OT_LORA.ALPHA, m["lora_alpha"]),
        "groups": (trainer.num_groups, m["groups"]),
        "shared_half_s": (bool(args.shared_half_s), m["shared_half_s"]),
        "lambda_fairness": (cfg.TRAINER.LAMBDA_FAIRNESS, m["lambda_fairness"]),
        "avg_prompt": (args.avg_prompt, m["avg_prompt"]),
        "local_s": (bool(cfg.TRAINER.GLP_OT_LORA.LOCAL_S), False),
        "optim": (cfg.OPTIM.NAME, "sgd"), "lr": (cfg.OPTIM.LR, o["lr"]),
        "momentum": (cfg.OPTIM.MOMENTUM, o["momentum"]),
        "weight_decay": (cfg.OPTIM.WEIGHT_DECAY, o["weight_decay"]),
        "nesterov": (bool(cfg.OPTIM.SGD_NESTEROV), False),
        "steps_per_batch": (trainer.opt_steps_per_batch, o["steps_per_batch"]),
        "classnames": (list(trainer.dm.dataset.classnames), cell.traffic["classnames"]),
        "attribute_type": (cfg.DATASET.ATTRIBUTE_TYPE, cell.traffic["attribute_type"]),
        "parallel_clients": (bool(cfg.TRAIN.PARALLEL_CLIENTS), True),
    }
    bad = {k: v for k, v in want.items() if v[0] != v[1]}
    if bad:
        raise RuntimeError(f"the program does not run the configuration as stated: "
                           f"{ {k: f'{a!r} (wants {b!r})' for k, (a, b) in bad.items()} }")


class RoundLoop:
    """The CLI's FedOTPLoRA branch over the runner, one round at a time."""

    def __init__(self, fm, runner, trainer, args, cfg):
        self.fm, self.runner, self.trainer, self.args = fm, runner, trainer, args
        self.max_epoch = cfg.OPTIM.ROUND
        self.users = args.idxs_users_test or list(range(cfg.DATASET.USERS))
        self.start = time.time()
        self.lists = ([], [], [], [], [], [])  # the CLI's per-round metric lists
        self.failed = 0

    def dispatch(self, epoch: int):
        users = self.fm._pick_users(self.args, epoch)
        t = time.perf_counter()
        with _span("dispatch"):
            handle = self.runner.run_round(epoch, list(users), self.max_epoch, mode="ema_personal",
                                           test_users=self.users, eval_users=self.users,
                                           deferred=True)
        return handle, time.perf_counter() - t

    def flush(self, handle, capture: list = None) -> dict:
        """Round ``handle``'s blocking half, as the CLI's parked flush; with
        ``capture`` the round's evaluation is appended to it
        (``check.capture_eval``)."""
        epoch = handle["epoch"]
        t0 = time.perf_counter()
        with _span("fetch"):
            ms = self.runner.resolve_round(handle)
        t1 = time.perf_counter()
        pend = self.runner._pending_eval
        if capture is not None:
            capture.append(check.capture_eval(self.runner, handle))
        with _span("eval"):
            results = self.runner.parallel_eval(self.users, epoch)
            if results is None:  # no device eval cache: the CLI's sequential evaluation
                results = []
                for idx in self.users:
                    self.runner.install_client(idx)
                    results.append(self.trainer.test(idx=int(idx), current_epoch=epoch))
            self.fm._summarize(results, self.start, *self.lists, epoch, with_auc=True)
        t2 = time.perf_counter()
        finite = bool(np.isfinite(ms).all()) and all(
            math.isfinite(float(v)) for r in results for v in r if np.isscalar(v))
        self.failed += 0 if finite else 1
        n_valids = [] if pend is None else pend["n_valids"]
        return {"epoch": epoch, "fetch_s": t1 - t0, "eval_s": t2 - t1,
                "n_steps": [int(n) for n in handle["n_steps"]],
                "eval_rows": sum(int(v) for vs in n_valids for v in vs),
                "eval_batches": sum(len(vs) for vs in n_valids),
                # the program pads every client to the longest one's batches
                "eval_batches_run": len(n_valids) * max(map(len, n_valids), default=0)}


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool, device: str,
             workdir: str, t_start: float, log=sys.stderr, faults=None, extra=None) -> Run:
    """One run; returns what it measured and the readings the check
    compared.  ``faults`` (tests) breaks the timed path: a callable given
    the runner before round 0.  ``extra`` (the control) adds readings, with
    the same arguments as :func:`compare`, once the program is freed."""
    device = torch.device(device)
    parts = {}  # the set-up's parts, filled as they finish
    t = time.perf_counter()
    shutil.rmtree(workdir, ignore_errors=True)
    data_root = os.path.join(workdir, "data")
    fixture = inputs.write_fixture(data_root, cell.traffic, seed, device)
    parts["fixture_s"] = time.perf_counter() - t

    t = time.perf_counter()
    ckpt = inputs.checkpoint_file(data_root, cell.config["backbone"])
    os.makedirs(os.path.dirname(ckpt), exist_ok=True)
    torch.save(inputs.make_checkpoint(cell.config["arch"], seed, device, cell.config.get("init")),
               ckpt)
    parts["checkpoint_s"] = time.perf_counter() - t

    t = time.perf_counter()
    from fairfedmed_tpu_torch import federated_main as fm
    from fairfedmed_tpu_torch.utils.tools import set_random_seed
    parts["import_s"] = time.perf_counter() - t

    t = time.perf_counter()
    log_path = os.path.join(workdir, "program.log")
    program_log = open(log_path, "w")
    try:
        with contextlib.redirect_stdout(program_log):
            result = _drive(cell, seed, seconds, trace, device, workdir, data_root, fixture,
                            fm, set_random_seed, parts, t, t_start, log, faults, extra)
    except BaseException:
        program_log.close()
        with open(log_path) as f:
            tail = f.read()[-4000:]
        print(f"program output (tail):\n{tail}", file=log)
        raise
    program_log.close()
    return result


def _drive(cell, seed, seconds, trace, device, workdir, data_root, fixture, fm,
           set_random_seed, parts, t_build, t_start, log, faults, extra):
    argv = build_argv(cell, data_root, os.path.join(workdir, "out"), seed)
    args = fm.build_arg_parser().parse_args(argv)
    args.idxs_users_train = fm._int_list(args.idxs_users_train)
    args.idxs_users_test = fm._int_list(args.idxs_users_test)
    cfg = fm.setup_cfg(args)
    # the CLI's main(): seed, trainer, the aggregation counts, the runner.  The
    # trainer gets no TensorBoard writer: where TensorFlow is installed,
    # importing the writer loads it, and it loads JAX
    set_random_seed(cfg.SEED)
    trainer = fm.build_trainer(cfg, device=device)
    check_program_config(cfg, args, trainer, cell)
    datanumber, by_attr = [], []
    for i in range(cfg.DATASET.USERS):
        ds = trainer.fed_train_loader_x_dict[i].dataset
        datanumber.append(len(ds))
        by_attr.append(ds.count_by_attribute(args.attribute_type))
    width = max(len(c) for c in by_attr)
    by_attr = [c + [0] * (width - len(c)) for c in by_attr]
    runner = fm._build_runner(cfg, args, trainer, datanumber, by_attr)
    if runner is None:
        raise RuntimeError("the program built no client-parallel runner for this configuration")
    parts["build_s"] = time.perf_counter() - t_build

    run = Run(cell, cfg.DATALOADER.TRAIN_X.BATCH_SIZE, cfg.DATALOADER.TEST.BATCH_SIZE)
    run.parts = parts
    loop = RoundLoop(fm, runner, trainer, args, cfg)
    if faults is not None:
        faults(runner)

    # round 0 through the window's own call, the first client's start recorded
    t = time.perf_counter()
    key = (None, None)
    recorder = check.StepRecorder(runner._steps[key], steps=0)
    runner._steps[key] = recorder
    handle, _ = loop.dispatch(0)
    runner._steps[key] = recorder.step
    round0 = check.capture_start(recorder, handle)
    del recorder
    loop.flush(handle)
    del handle
    run.round0_s = parts["round0_s"] = time.perf_counter() - t

    # the rounds up to the check's, the last recorded through the same calls
    # (check.py): the first client's first steps, every client's trained
    # state, the aggregation and the evaluation, copied to the host, so the
    # check reads the same training state however fast the window runs
    t = time.perf_counter()
    check_round = cell.workload["check_round"]
    for epoch in range(1, check_round):
        handle, _ = loop.dispatch(epoch)
        loop.flush(handle)
    recorded = record_round(loop, runner, check_round, run.batch_size)
    parts["check_rounds_s"] = time.perf_counter() - t
    loop.failed = 0  # count the window's rounds
    _sync(device)
    gc.collect()
    cpu0 = time.process_time()
    setup_s = time.perf_counter() - t_start

    # the window: whole rounds back to back until `seconds` have passed
    epoch, pending = check_round + 1, None
    t0 = time.perf_counter()
    while True:
        handle, disp = loop.dispatch(epoch)
        if pending is not None:
            run.rounds.append({**loop.flush(pending[0]), "dispatch_s": pending[1]})
        pending = (handle, disp)
        epoch += 1
        if time.perf_counter() - t0 >= seconds:
            break
    if not trace:
        run.rounds.append({**loop.flush(pending[0]), "dispatch_s": pending[1]})
        pending = None
    window_s = time.perf_counter() - t0
    n_rounds = epoch - check_round - 1
    cpu_s = time.process_time() - cpu0

    if trace:  # the traced tail: `trace_rounds` more rounds under the profiler
        run.rounds.append({**loop.flush(pending[0]), "dispatch_s": pending[1]})
        pending = None
        trace_path = os.path.join(workdir, "trace.json")
        _sync(device)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(cell.workload["trace_rounds"]):
                handle, disp = loop.dispatch(epoch)
                if pending is not None:
                    run.traced_rounds.append({**loop.flush(pending[0]), "dispatch_s": pending[1]})
                pending = (handle, disp)
                epoch += 1
            with _span("sync"):
                _sync(device)
        t = time.perf_counter()
        prof.export_chrome_trace(trace_path)
        run.trace = reduce_trace(trace_path)
        os.remove(trace_path)
        parts["trace_read_s"] = time.perf_counter() - t
        last = loop.flush(pending[0])
        run.traced_rounds.append({**last, "dispatch_s": pending[1]})

    run.setup_s, run.window_s, run.n_rounds, run.failed = setup_s, window_s, n_rounds, loop.failed
    run.peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    # the round after the window and the traced tail, through the same calls:
    # the state that every round of the window left behind
    late = record_round(loop, runner, epoch, run.batch_size)

    found = forbidden_modules()
    if found:
        raise RuntimeError(f"modules of JAX or the JAX package are loaded: {found}")
    print(f"set-up parts (s): {parts}", file=log)
    print(f"window: {n_rounds} rounds in {window_s:.3f} s; rounds failed {loop.failed}; "
          f"CPU seconds of this process in it: {cpu_s:.3f}", file=log)

    # free the program's state before the reference runs
    del loop, runner, trainer, handle, pending
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    run.readings = compare(cell, fixture, data_root, round0, recorded, late, device)
    if extra is not None:
        run.readings.update(extra(cell, fixture, data_root, round0, recorded, late, device))
    print(f"reference check: {time.perf_counter() - t:.1f} s", file=log)
    return run


def record_round(loop: RoundLoop, runner, epoch: int, batch_size: int) -> dict:
    """Round ``epoch`` dispatched and flushed with ``check.StepRecorder`` in
    place of the runner's local step: what the check reads of it
    (``check.capture_round`` and the evaluation), copied to the host."""
    key = (None, None)
    prev_global = check._clone(runner.global_t, "cpu")
    recorder = check.StepRecorder(runner._steps[key], to="cpu")
    runner._steps[key] = recorder
    handle, _ = loop.dispatch(epoch)
    runner._steps[key] = recorder.step
    recorded = check.capture_round(recorder, handle, prev_global, batch_size)
    evals = []
    loop.flush(handle, capture=evals)
    recorded["eval"] = evals[0]
    return recorded


def reference_model(cell, data_root, device, prec="fp32"):
    sd = torch.load(inputs.checkpoint_file(data_root, cell.config["backbone"]), map_location="cpu")
    return ref.ReferenceCLIP(sd, cell.config, cell.traffic, device, prec)


@contextlib.contextmanager
def no_tf32():
    """Float32 products in float32: TF32 off for matmuls and convolutions."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def compare(cell, fixture, data_root, round0, recorded, late, device) -> dict:
    """The numbers of ``check.NUMBERS``, the program against the float32
    reference: of the check round, and with the prefix ``late_`` of the
    round after the window."""
    with no_tf32():
        model = reference_model(cell, data_root, device)
        out = check.start_readings(round0, model, cell)
        for prefix, cap in (("", recorded), ("late_", late)):
            readings = check.step_readings(cap, fixture, model, cell, device)
            agg = check.agg_reference(cap, fixture, cell)
            readings.update(check.agg_readings(cap, agg))
            want = check.eval_logits(cap["eval"], fixture, model, cell, device, agg)
            readings.update(check.eval_readings(cap["eval"], want, model))
            out.update({prefix + k: v for k, v in readings.items()})
        return out


def verdict(readings: dict, limits: dict) -> tuple:
    """(correct, [(name, value, limit)]): every number of ``check.NUMBERS``
    that the cell gives a limit within it (a number that was not read
    fails); the others, and ``check.REPORTED``, follow with limit None."""
    rows = [(name, readings.get(name, math.nan), limits[name]) for name in check.NUMBERS]
    ok = all(math.isfinite(v) and v <= lim for _, v, lim in rows if lim is not None)
    return ok, rows + [(name, readings.get(name, math.nan), None) for name in check.REPORTED]
