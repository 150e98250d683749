"""Whether what the timed path produced is correct.

The window's entry is the program's client-parallel round
(``ParallelRoundRunner.run_round`` / ``resolve_round`` / ``parallel_eval``).
Three rounds go through that same call with ``StepRecorder`` put in place
of the runner's local step: round 0 (set-up), whose first client's start
state is the method's initialisation; the round at the cell's
``check_round`` (epoch >= 1, so it starts from an aggregated state and the
clients' carried momentum, and its EMA takes a nonzero ``beta_decay``),
dispatched before the window, so the training state it reads does not hang
on how many rounds the window runs; and the round right after the window
(and the traced tail), which reads the state every timed round left
behind.  Of the last two the recorder keeps, on the host, the first
client's start state and first three steps (batches, rates, outputs) and
every client's last step; the round's evaluation is fetched as the CLI
fetches it.  After the window, once the program's state
is freed, the plain reference (``reference/model.py``, float32) follows
from the program's start state.  The numbers compared (``NUMBERS``), each
against its limit from the cell's workload file:

* ``start_gap`` (round 0): the largest deviation of the deterministic part
  of the start state from what the method prescribes (lora_A zero, lora_S's
  ``same+cycle`` values, BatchNorm from the checkpoint, optimizer state zero);
* ``init_std_gap`` (round 0): how far the spread of the random part of the
  start state (the prompt context, N(0, 0.02); lora_B, N(0, 1)) lies from
  its rule;
* ``feed_gap``: share of the first three batches' rows that are not a row of
  the client's train set (image, label and group as the benchmark wrote
  them), that repeat, or that are missing from a full batch;
* ``loss_gap``: the worst of the three steps' losses against the
  reference's, relative;
* ``grad_norm_gap``: per leaf, the gap between the norms of the first
  gradient as the optimizer got it (worked out from the program's optimizer
  state before and after the first step) and of the reference's, over the
  larger of the latter and the median leaf's; the worst leaf;
* ``grad_gap``: 1 - cos of the angle between the same two gradients, all
  trainable leaves taken as one vector;
* ``change_norm_gap`` and ``change_gap``: the same two of the state's change
  over the three steps (as step 4 gets it; BatchNorm statistics in the
  norms; ``change_gap`` 1 where either did not move);
* ``stats_gap``: 1 - cos of the angle between the BatchNorm running
  statistics' change over the three steps and the reference's (read only
  where the tower has BatchNorm);
* ``agg_gap``: the round's new global and per-client state against the
  reference's EMA aggregation (at the round's ``beta_decay``) of the
  program's trained clients, the worst leaf's relative difference;
* ``eval_gap``: the round's evaluation logits of every test row of every
  client against the reference's logits from its own aggregated state, the
  worst gap over the logit scale exp(logit_scale) (so in units of cosine);
* ``late_feed_gap``, ``late_change_gap``, ``late_agg_gap``,
  ``late_eval_gap``: the same four of the round after the window.  The
  step's other numbers grow with the training behind the round and are
  compared at the check round alone; ``change_gap`` reads 1 for a step that
  stopped moving the state, however late.

A cell's workload file gives each number its limit, or none where no limit
separates sound runs from the control and the faults (PERF.md gives the
readings); such a number is printed and not compared.  Leaves whose
reference gradient is under a thousandth of the median leaf's are left out
of the four gradient and change numbers (they move by round-off alone).
Printed beside them (``REPORTED``): ``eval_rms_gap``, ``eval_gap``'s root
mean square.
"""

from __future__ import annotations

import hashlib
import math

import numpy as np
import torch

from . import spec
from .reference import model as ref

NUMBERS = ("start_gap", "init_std_gap", "feed_gap", "loss_gap", "grad_norm_gap", "grad_gap",
           "change_norm_gap", "change_gap", "stats_gap", "agg_gap", "eval_gap",
           "late_feed_gap", "late_change_gap", "late_agg_gap", "late_eval_gap")
REPORTED = ("eval_rms_gap",)
STEPS = 3  # the reference follows the first three steps
TINY = 1e-3  # a leaf whose reference gradient is under this share of the median leaf's is left out


def _clone(tree: dict, to=None) -> dict:
    """Copies of ``tree``'s tensors, on ``to`` (None: where each is)."""
    return {k: v.detach().to(to, copy=True) if to is not None else v.detach().clone()
            for k, v in tree.items()}


class StepRecorder:
    """Stands in for the runner's local step during one round: calls it,
    keeps the first client's start state and first ``steps`` batches and
    outputs (copies, made around the step, on ``to``: None keeps them on the
    device), and each client's last output (a client's run of steps ends
    where a call's state is not the previous call's output)."""

    def __init__(self, step, steps: int = STEPS, to=None):
        self.step, self.steps, self.to = step, steps, to
        self.start = None
        self.batches, self.lrs, self.outputs, self.ends = [], [], [], []
        self._last = None

    def __call__(self, params, opt_state, batch, lr, ctx_global=None):
        if self.start is None:
            self.start = (_clone(params, self.to), _clone(opt_state, self.to))
        if self._last is not None and params is not self._last[0]:
            self.ends.append(self._last)
        first = len(self.batches) < self.steps and not self.ends
        if first:
            self.batches.append(_clone(batch, self.to))
            self.lrs.append(float(lr))
        out = self.step(params, opt_state, batch, lr, ctx_global)
        if first:
            self.outputs.append((_clone(out[0], self.to), _clone(out[1], self.to),
                                 out[2].detach().float().cpu()))
        self._last = out
        return out

    def trained(self) -> list:
        """Every client's state after its last step, in the round's order."""
        return [_clone(o[0], self.to) for o in self.ends + [self._last]]


def capture_start(rec: StepRecorder, handle: dict) -> dict:
    """Round 0's first client and its start state."""
    return {"users": list(handle["idxs_users"]), "start": rec.start}


def capture_round(rec: StepRecorder, handle: dict, prev_global: dict, batch_size: int) -> dict:
    """Everything the reference needs from the recorded round, copied right
    after its dispatch: the first client's start state, batches and first
    three outputs, each client's trained state, the state before the round
    and the aggregation's result."""
    if len(rec.outputs) < STEPS:
        raise RuntimeError(f"the step hook saw {len(rec.outputs)} steps of the round's first "
                           f"client, fewer than the {STEPS} the check follows")
    trained = rec.trained()
    if len(trained) != len(handle["n_steps"]):
        raise RuntimeError(f"the round trained {len(trained)} clients, its handle names "
                           f"{len(handle['n_steps'])}")
    global_t, personal_t, _ = handle["state"]
    return {
        "epoch": handle["epoch"], "max_epoch": handle["max_epoch"],
        "users": list(handle["idxs_users"]), "batch_size": batch_size,
        "start": rec.start, "lrs": rec.lrs,
        "batches": [{k: v.cpu() for k, v in b.items()} for b in rec.batches],
        "outputs": rec.outputs[:STEPS],
        "trained": trained,
        "prev_global": prev_global,
        "global": _clone(global_t, rec.to),
        "personal": _clone(personal_t, rec.to),
    }


def capture_eval(runner, handle: dict) -> dict:
    """The round's evaluation as the program produced it: which rows and
    the logits fetched."""
    pend = runner._pending_eval
    if pend is None or "logits_host" not in pend:
        raise RuntimeError("the round enqueued no device evaluation to compare")
    return {"epoch": handle["epoch"], "idxs": list(pend["idxs"]), "mats": pend["mats"],
            "n_valids": pend["n_valids"], "logits": np.asarray(pend["logits_host"])}


# --------------------------------------------------------------------------- readings


def _norm(t: torch.Tensor) -> float:
    return float(t.double().norm())


def per_layer(tree: dict) -> dict:
    """The leaves with the ViT's layer-stacked adapters split into one leaf
    per layer (``<name>[i]``), so a fault in one layer is not averaged away
    over twelve."""
    out = {}
    for k, v in tree.items():
        if k.startswith("image_encoder_lora.") and v.dim() == 3 and k.count(".") == 2:
            out.update({f"{k}[{i}]": v[i] for i in range(v.shape[0])})
        else:
            out[k] = v
    return out


def _median_nonzero(norms) -> float:
    nonzero = [n for n in norms if n > 0]
    return float(np.median(nonzero)) if nonzero else 0.0


def norm_gap(prog: dict, refs: dict, keep=None) -> tuple:
    """(worst leaf's |‖prog‖ − ‖ref‖| / max(‖ref‖, median leaf ‖ref‖), its
    name); the median is over the leaves that moved at all."""
    prog, refs = per_layer(prog), per_layer(refs)
    keys = [k for k in refs if keep is None or k in keep]
    ref_norms = {k: _norm(refs[k]) for k in keys}
    median = _median_nonzero(ref_norms.values())
    worst, name = 0.0, None
    for k in keys:
        gap = abs(_norm(prog[k]) - ref_norms[k]) / max(ref_norms[k], median, 1e-30)
        if gap >= worst:
            worst, name = gap, k
    return worst, name


def cos_gap(prog: dict, refs: dict, keys) -> float:
    """1 - cos of the angle between the program's and the reference's
    ``keys`` leaves, taken as one vector (1 where either is zero)."""
    dot = na = nb = 0.0
    for k in keys:
        a, b = prog[k].double().reshape(-1).cpu(), refs[k].double().reshape(-1).cpu()
        dot += float(a @ b)
        na += float(a @ a)
        nb += float(b @ b)
    return 1.0 if na == 0 or nb == 0 else 1.0 - dot / math.sqrt(na * nb)


def gradient_from_optimizer(p0: dict, o0: dict, opt1: dict, lr: float, optim: dict) -> dict:
    """The gradient the optimizer stepped on, from the start parameters and
    momentum and the momentum after one batch: every quantity of
    ``steps_per_batch`` SGD steps is affine in the gradient g, so the
    momentum after them is a * g + b and g = (momentum - b) / a."""
    out = {}
    m, wd = optim["momentum"], optim["weight_decay"]
    for k, p in p0.items():
        p = p.double().cpu()
        a_t, b_t = 0.0, _momentum(o0, k, p).double()  # momentum = a_t * g + b_t
        a_p, b_p = 0.0, p  # parameter = a_p * g + b_p
        for _ in range(optim["steps_per_batch"]):
            a_t, b_t = 1.0 + wd * a_p + m * a_t, wd * b_p + m * b_t
            a_p, b_p = a_p - lr * a_t, b_p - lr * b_t
        out[k] = ((opt1[f"trace:{k}"].double().cpu() - b_t) / a_t).float()
    return out


def _momentum(opt: dict, key: str, like: torch.Tensor) -> torch.Tensor:
    """The SGD momentum of leaf ``key`` in the program's optimizer state."""
    t = opt.get(f"trace:{key}")
    return torch.zeros_like(like) if t is None else t.to(like.device)


def _site_rows(fixture: dict, site: int, split: str, traffic: dict):
    """(what the dataset gives the model, labels, groups) of a site's split."""
    d, attr = fixture[site][split], traffic["attribute_type"]
    fed = spec.load_modality(traffic["modality"]).fed(d["pixels"], traffic)
    return fed, d["label"].astype(np.int64), d["attrs"][attr].astype(np.int64)


def _identify(batch: dict, images: np.ndarray, labels, groups) -> tuple:
    """(dataset indices of the batch rows, share of rows that are no row of
    the set or repeat)."""
    index = {hashlib.blake2b(img.tobytes(), digest_size=16).digest(): i
             for i, img in enumerate(images)}
    img = batch["img"].numpy()
    rows, bad = [], 0
    for r in range(img.shape[0]):
        i = index.get(hashlib.blake2b(np.ascontiguousarray(img[r]).tobytes(),
                                      digest_size=16).digest())
        if (i is None or int(batch["label"][r]) != labels[i]
                or ("attr" in batch and int(batch["attr"][r]) != groups[i])):
            bad += 1
            i = -1
        rows.append(i)
    return rows, bad


def step_readings(cap: dict, fixture: dict, model: ref.ReferenceCLIP, cell, device) -> dict:
    """feed_gap and the loss, gradient, change and statistics numbers of the
    program's first three steps against ``model``."""
    optim = cell.config["optim"]
    site = cap["users"][0] + 1
    images, labels, groups = _site_rows(fixture, site, "train", cell.traffic)
    idx, bad = [], 0
    for b in cap["batches"]:
        rows, n_bad = _identify(b, images, labels, groups)
        idx.append(rows)
        bad += n_bad
    flat = [i for rows in idx for i in rows if i >= 0]
    bad += len(flat) - len(set(flat))
    bad += sum(max(0, cap["batch_size"] - len(r)) for r in idx)  # rows left out of a batch
    n_rows = cap["batch_size"] * len(idx)
    out = {"feed_gap": bad / n_rows}
    if bad:
        return out

    p0, o0 = cap["start"]
    state = {k: v.to(device).float() for k, v in p0.items()}
    trace = {k: _momentum(o0, k, state[k]).float() for k in ref.trainable_keys(state)}
    losses, first_grad = [], None
    for s in range(STEPS):
        sel = torch.as_tensor(idx[s])
        batch = {"img": torch.as_tensor(images)[sel].to(device),
                 "label": torch.as_tensor(labels)[sel].to(device),
                 "attr": torch.as_tensor(groups)[sel].to(device)}
        state, trace, loss, grads = ref.train_step(model, state, trace, batch, cap["lrs"][s],
                                                   optim)
        losses.append(loss)
        if first_grad is None:
            first_grad = grads
    prog_loss = [float(cap["outputs"][s][2][0]) for s in range(STEPS)]
    out["loss_gap"] = max(abs(p - r) / abs(r) for p, r in zip(prog_loss, losses))

    keys = ref.trainable_keys(p0)
    g_prog = gradient_from_optimizer({k: p0[k] for k in keys}, o0, cap["outputs"][0][1],
                                     cap["lrs"][0], optim)
    g_norms = {k: _norm(v) for k, v in per_layer({k: first_grad[k] for k in keys}).items()}
    median = _median_nonzero(g_norms.values())
    counted = {k for k, n in g_norms.items() if n >= TINY * median}
    out["grad_norm_gap"], out["grad_norm_gap_leaf"] = norm_gap(g_prog, first_grad, counted)
    out["grad_gap"] = cos_gap(per_layer(g_prog), per_layer(first_grad), counted)

    p3 = cap["outputs"][STEPS - 1][0]
    d_prog = {k: p3[k].float().cpu() - p0[k].float().cpu() for k in p0}
    d_ref = {k: state[k].cpu() - p0[k].float().cpu() for k in p0}
    out["change_gap"] = cos_gap(per_layer(d_prog), per_layer(d_ref), counted)
    stats = [k for k in p0 if k not in keys]  # BatchNorm statistics
    out["change_norm_gap"], out["change_norm_gap_leaf"] = norm_gap(d_prog, d_ref,
                                                                   counted | set(stats))
    if stats:
        out["stats_gap"] = cos_gap(d_prog, d_ref, stats)
    out["ref_loss"] = losses
    out["prog_loss"] = prog_loss
    return out


def start_readings(cap: dict, model: ref.ReferenceCLIP, cell) -> dict:
    """start_gap and init_std_gap of the first client's start state."""
    p0, o0 = cap["start"]
    method = cell.config["method"]
    rank, groups = method["lora_rank"], method["groups"]
    exact = 0.0
    for k, v in o0.items():
        exact = max(exact, float(v.double().abs().max()))
    half = rank // 2
    base = torch.linspace(0.5, 0.1, half)
    step = half // groups
    s_init = torch.cat([base[None].repeat(groups, 1),
                        torch.stack([torch.roll(base, -g * step) for g in range(groups)]) * 0.2],
                       dim=1)
    stds = []
    for k, v in p0.items():
        v = v.double().cpu()
        if k.endswith("lora_A"):
            exact = max(exact, float(v.abs().max()))
        elif k.endswith("lora_S"):
            exact = max(exact, float((v - s_init.expand_as(v)).abs().max()))
        elif k.startswith("visual_bn.") or k.startswith("__bn_stats__."):
            path, leaf = k.split(".", 1)[1].rsplit(".", 1)
            ck = _checkpoint_bn_key(path, {"weight": "weight", "bias": "bias", "mean": "running_mean",
                                           "var": "running_var"}[leaf])
            exact = max(exact, float((v - model.sd[ck].double().cpu()).abs().max()))
        elif k.endswith("lora_B"):
            stds.append(abs(float(v.std()) - 1.0))
        elif k == "prompt_learner.ctx":
            stds.append(abs(float(v.std()) / 0.02 - 1.0))
    return {"start_gap": exact, "init_std_gap": max(stds)}


def _checkpoint_bn_key(path: str, leaf: str) -> str:
    """``stem.bn1`` -> ``visual.bn1``; ``layer1.0.downsample_bn`` ->
    ``visual.layer1.0.downsample.1``."""
    if path.startswith("stem."):
        return f"visual.{path[5:]}.{leaf}"
    if path.endswith("downsample_bn"):
        return f"visual.{path[:-len('downsample_bn')]}downsample.1.{leaf}"
    return f"visual.{path}.{leaf}"


def _rel(prog: torch.Tensor, want: torch.Tensor) -> float:
    return _norm(prog.float().cpu() - want.float().cpu()) / max(_norm(want.float().cpu()), 1e-30)


def agg_reference(cap: dict, fixture: dict, cell, prec: str = "fp32") -> dict:
    """The reference's EMA aggregation of the recorded round's trained
    clients into its previous global state, computed in ``prec``."""
    attr = cell.traffic["attribute_type"]
    method = cell.config["method"]
    users = cap["users"]
    sizes = np.asarray([len(fixture[u + 1]["train"]["label"]) for u in users], np.float64)
    hist = np.stack([np.bincount(fixture[u + 1]["train"]["attrs"][attr],
                                 minlength=method["groups"]) for u in users]).astype(np.float64)
    weights = torch.as_tensor(sizes / sizes.sum(), dtype=torch.float32)
    group_w = torch.as_tensor(hist / hist.sum(0, keepdims=True), dtype=torch.float32)
    num = ref.Numerics(prec)
    trained = [{k: num.q(v.float().cpu()) for k, v in t.items()} for t in cap["trained"]]
    prev = {k: num.q(v.float().cpu()) for k, v in cap["prev_global"].items()}
    beta_decay = 0.999 * cap["epoch"] / max(cap["max_epoch"], 1)
    return ref.aggregate(prev, trained, weights, group_w, method["groups"], beta_decay,
                         method["shared_half_s"])


def agg_readings(cap: dict, want: dict) -> dict:
    """agg_gap: the recorded round's new global state and every test user's
    state against the reference's aggregation ``want`` (every test user
    takes the new global: no user keeps local rows under the launcher's
    flags)."""
    gap = 0.0
    for k, w in want.items():
        gap = max(gap, _rel(cap["global"][k], w))
        for c in range(cap["personal"][k].shape[0]):
            gap = max(gap, _rel(cap["personal"][k][c], w))
    return {"agg_gap": gap}


@torch.no_grad()
def eval_logits(ev: dict, fixture: dict, model: ref.ReferenceCLIP, cell, device,
                state: dict) -> np.ndarray:
    """The reference's logits from ``state`` (every test user's) of every
    row the program evaluated, laid out as the program's ([clients, batches,
    batch, classes]; padding rows 0)."""
    out = np.zeros(ev["logits"].shape, np.float64)
    state = {k: v.to(device).float() for k, v in state.items()}
    for j, user in enumerate(ev["idxs"]):
        images, _, groups = _site_rows(fixture, user + 1, "test", cell.traffic)
        for row, valid in enumerate(ev["n_valids"][j]):
            sel = ev["mats"][j][row, :valid]
            want, _ = model.logits(state, torch.as_tensor(images[sel]).to(device),
                                   torch.as_tensor(groups[sel]).to(device), train=False)
            out[j, row, :valid] = want.double().cpu().numpy()
    return out


def valid_rows(ev: dict) -> np.ndarray:
    valid = np.zeros(ev["logits"].shape[:3], bool)
    for j, vs in enumerate(ev["n_valids"]):
        for row, v in enumerate(vs):
            valid[j, row, :v] = True
    return valid


def eval_readings(ev: dict, want: np.ndarray, model: ref.ReferenceCLIP) -> dict:
    """eval_gap: the worst gap of a valid row's logit to the reference's
    ``want`` (``eval_logits``) over the logit scale; beside it their root
    mean square."""
    valid = valid_rows(ev)
    got, want = ev["logits"].astype(np.float64)[valid], want[valid]
    scale = float(model.sd["logit_scale"].exp())
    return {"eval_gap": float(np.abs(got - want).max()) / scale,
            "eval_rms_gap": math.sqrt(float(((got - want) ** 2).mean())) / scale}


def reference_as_program(cap: dict, fixture: dict, model: ref.ReferenceCLIP, cell, device,
                         rows_of=None) -> dict:
    """``cap`` with the first three steps' outputs made by ``model`` in the
    program's place (the control, or a fault planted in the reference):
    the same start, batches and rates.  ``rows_of(batch_size)`` keeps some
    of each batch's rows, the others left out of the step (a fault)."""
    optim = cell.config["optim"]
    images, labels, groups = _site_rows(fixture, cap["users"][0] + 1, "train", cell.traffic)
    idx = [_identify(b, images, labels, groups)[0] for b in cap["batches"]]
    p0, o0 = cap["start"]
    state = {k: v.to(device).float() for k, v in p0.items()}
    trace = {k: _momentum(o0, k, state[k]).float() for k in ref.trainable_keys(state)}
    outputs = []
    for s in range(STEPS):
        sel = torch.as_tensor(idx[s])
        if rows_of is not None:
            sel = sel[rows_of(len(sel))]
        batch = {"img": torch.as_tensor(images)[sel].to(device),
                 "label": torch.as_tensor(labels)[sel].to(device),
                 "attr": torch.as_tensor(groups)[sel].to(device)}
        state, trace, loss, _ = ref.train_step(model, state, trace, batch, cap["lrs"][s], optim)
        outputs.append(({k: v.clone() for k, v in state.items()},
                        {f"trace:{k}": v.clone() for k, v in trace.items()},
                        torch.tensor([loss, 1.0, 0.0])))
    return {**cap, "outputs": outputs}
