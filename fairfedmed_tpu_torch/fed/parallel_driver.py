"""Client-parallel federated rounds on one card.

Port of ``fairfedmed_tpu/fed/parallel_driver.py`` (``--parallel_clients``):
the CLI's fedavg, fedprox, PromptFL/FedOTP, FedOTPLinearFT, FedOTPLoRA and
local branches, on ViT and ResNet (whose per-client BatchNorm statistics
ride the client state as ``__bn_stats__``).  In place of the sequential
loop's state_dict harvest, deep copies and host aggregation per client:

* every client's trainable state and optimizer state stay on the device,
  stacked on a leading client axis, from round to round; a round gathers
  the selected clients' rows, trains them and scatters them back, with no
  host copy of a weight or an optimizer state inside the round;
* each client's train and test sets are decoded once into device caches
  (uint8 where the pixels are integral) under one budget for the whole
  fleet, ``FAIRFEDMED_DEVICE_CACHE_BYTES`` (4 GiB by default); a round draws
  the sequential loader's ``np.random.permutation`` per client and gathers
  its batches on the device;
* aggregation and personalisation are PyTorch over the stacked clients
  (``fed/parallel.py``);
* ``run_round(..., deferred=True)`` only enqueues work: the host never waits
  for the device there once the caches are filled (round 0).
  ``resolve_round`` makes the round's one blocking fetch, the train
  metrics and the round's evaluation logits together.

The JAX package runs a round as one SPMD program over a device mesh; on one
device it trains its clients one after another, as this runner does.  Mesh
rounds over several cards and round-state checkpoints are not ported.

Intended differences from the sequential loop, as in the JAX package: each
client owns its optimizer state and keeps it across rounds (the sequential
loop steps every client through one optimizer, so the two agree only with
momentum-free SGD); under PromptFL/FedOTP the non-prompt trainables
(BatchNorm statistics included) stay per client; a client with fewer
samples than the batch trains one batch padded by cycling its samples.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch

from .aggregate import _freqs
from .parallel import (apply_shared_half_s, client_weighted_mean, ema_blend, personalize,
                       stack_clients)

CACHE_BYTES_ENV = "FAIRFEDMED_DEVICE_CACHE_BYTES"
MODES = ("ema_personal", "fedavg", "prompt_personal", "local_personal", "fedavg_personal")


def _pad_rows(arr: np.ndarray, n: int) -> np.ndarray:
    """The leading axis padded to ``n`` rows by cycling (np.resize)."""
    if arr.shape[0] == n:
        return arr
    reps = -(-n // arr.shape[0])
    return np.concatenate([arr] * reps, axis=0)[:n]


class ParallelRoundRunner:
    """Owns the per-client device state and runs the rounds.

    ``trainer`` is a built GLP_OT / GLP_OT_SVLoRA / PromptFL trainer; its
    ``parallel_trainable()`` and ``parallel_opt_state()`` seed every
    client.
    """

    def __init__(self, trainer, cfg, args, datanumber_client, datanumber_client_by_attr):
        self.trainer = trainer
        self.cfg = cfg
        self.args = args
        self.datanumber_client = list(datanumber_client)
        self.datanumber_client_by_attr = datanumber_client_by_attr
        self.num_users = cfg.DATASET.USERS
        self.num_groups = getattr(trainer, "num_groups", 1)
        self.avg_prompt = int(args.avg_prompt)
        self.local_s = bool(cfg.TRAINER.GLP_OT_LORA.LOCAL_S)
        self.shared_half_s = bool(args.shared_half_s)
        self.device = trainer.device

        self._steps = {None: trainer.make_parallel_local_step()}  # raises where unsupported
        base = trainer.parallel_trainable()
        opt0 = trainer.parallel_opt_state()
        n = self.num_users
        # every client starts from the trainer's init, as its own copy
        self.global_t = {k: v.clone() for k, v in base.items()}
        self.personal_t = {k: v[None].repeat((n,) + (1,) * v.dim()) for k, v in base.items()}
        self.stacked_o = {k: v[None].repeat((n,) + (1,) * v.dim()) for k, v in opt0.items()}
        self._infer = trainer.make_parallel_infer()

        self._data_cache = {}  # client -> device train set, or None
        self._eval_cache = {}  # client -> device test set, or None
        # ONE budget for every client's train and eval caches
        self._cache_budget = int(os.environ.get(CACHE_BYTES_ENV, 4 << 30))
        self._cached_bytes = 0
        self._pending_eval = None
        self.fetches = 0  # blocking device-to-host fetches made by resolve_round
        self._attr_col = None
        if not getattr(trainer, "disable_attr", True):
            self._attr_col = list(cfg.DATASET.ATTRIBUTES).index(cfg.DATASET.ATTRIBUTE_TYPE)

    # ------------------------------------------------------------- plumbing
    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        """A host array on the device without waiting for the copy: pinned,
        then a non-blocking copy (a copy from pageable memory would
        synchronise)."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _fetch(self, *tensors) -> list:
        """ONE blocking device-to-host transfer of ``tensors`` (as fp32)."""
        flat = torch.cat([t.float().reshape(-1) for t in tensors]).cpu().numpy()
        self.fetches += 1
        out, offset = [], 0
        for t in tensors:
            out.append(flat[offset:offset + t.numel()].reshape(tuple(t.shape)))
            offset += t.numel()
        return out

    def _local_step(self, fedprox_mu):
        if fedprox_mu not in self._steps:
            self._steps[fedprox_mu] = self.trainer.make_parallel_local_step(fedprox_mu=fedprox_mu)
        return self._steps[fedprox_mu]

    def _row(self, stacked: dict, idx: int) -> dict:
        return {k: v[idx] for k, v in stacked.items()}

    # ------------------------------------------------------------- device caches
    def _ensure_device_cache(self, idx: int):
        """Client ``idx``'s train set decoded once and kept on the device, or
        None (see ``_decode_loader``)."""
        if idx in self._data_cache:
            return self._data_cache[idx]
        decoded = self._decode_loader(self.trainer.fed_train_loader_x_dict[idx])
        cache = None
        if decoded is not None:
            imgs, labels, attrs = decoded
            cache = {"img": self._to_device(imgs),
                     "label": self._to_device(labels.astype(np.int64))}
            if self._attr_col is not None:
                cache["attr"] = self._to_device(attrs[:, self._attr_col].astype(np.int64))
            self._cached_bytes += imgs.nbytes
        self._data_cache[idx] = cache
        return cache

    def _ensure_eval_cache(self, idx: int):
        """Client ``idx``'s test set on the device (labels and attributes
        stay on the host for the evaluator), or None."""
        if idx in self._eval_cache:
            return self._eval_cache[idx]
        decoded = self._decode_loader(self.trainer.fed_test_loader_x_dict[idx])
        cache = None
        if decoded is not None:
            imgs, labels, attrs = decoded
            self._cached_bytes += imgs.nbytes
            cache = {"img": self._to_device(imgs), "label": labels, "attrs": attrs,
                     "attr_dev": (self._to_device(attrs[:, self._attr_col].astype(np.int64))
                                  if attrs is not None and self._attr_col is not None else None)}
        self._eval_cache[idx] = cache
        return cache

    def _decode_loader(self, loader):
        """A client loader's whole dataset in index order as (imgs, labels,
        attrs), or None when it cannot be cached: a host transform (the
        images change per epoch), no ``load_item``, an empty set, or a set
        that would take the fleet-wide cache (train and eval, every client)
        over its budget.  ``load_item_u8`` comes first; other integral fp32
        sets are stored as uint8, equal after the step's cast to float (JAX
        parallel_driver.py:198-313)."""
        ds = loader.dataset
        if loader.transform is not None or not hasattr(ds, "load_item"):
            return None
        n = len(ds)
        if n == 0:
            return None  # the host path trains such a client zero batches
        budget_left = self._cache_budget - self._cached_bytes
        u8_fn = getattr(ds, "load_item_u8", None)
        first_u8 = u8_fn(0) if u8_fn is not None else None
        items = imgs = None
        fb_start = 1  # where the float loop starts (after a reused uint8 prefix)
        prefetched = False
        if first_u8 is not None:
            if first_u8[0].nbytes * n > budget_left:
                return None
            if hasattr(ds, "prefetch"):
                ds.prefetch(range(1, n))
                prefetched = True
            u8_items = [first_u8]
            try:
                for i in range(1, n):
                    it = u8_fn(i)
                    if it is None:  # a mixed set: keep the uint8 prefix, go on in float
                        items, fb_start, u8_items = u8_items, i, None
                        break
                    u8_items.append(it)
            except BaseException:
                if hasattr(ds, "clear_prefetch"):
                    ds.clear_prefetch()
                raise
            if u8_items is not None:
                items = u8_items
                imgs = np.stack([it[0] for it in items])
        if imgs is None:
            # estimate from one item before decoding the set; an integral
            # first item predicts uint8 storage
            if items is None:
                items = [ds.load_item(0)]
            f0 = np.asarray(items[0][0], np.float32)
            est = f0.nbytes * n
            if (f0.size and 0.0 <= float(f0.min()) and float(f0.max()) <= 255.0
                    and np.array_equal(f0, f0.astype(np.uint8))):
                est //= 4
            if est > budget_left:
                if prefetched and hasattr(ds, "clear_prefetch"):
                    ds.clear_prefetch()
                return None
            if hasattr(ds, "prefetch") and not prefetched:
                ds.prefetch(range(1, n))
                prefetched = True
            try:
                for i in range(fb_start, n):
                    items.append(ds.load_item(i))
            except BaseException:
                if prefetched and hasattr(ds, "clear_prefetch"):
                    ds.clear_prefetch()
                raise
            imgs = np.stack([np.asarray(it[0], np.float32) for it in items])
            if imgs.size and 0.0 <= float(imgs.min()) and float(imgs.max()) <= 255.0:
                as_u8 = imgs.astype(np.uint8)
                if np.array_equal(imgs, as_u8):
                    imgs = as_u8
            if imgs.nbytes > budget_left:  # the stored size counts
                return None
        labels = np.asarray([it[1] for it in items], np.int32)
        attrs = (np.stack([it[2] for it in items]).astype(np.int32)
                 if items[0][2] is not None else None)
        return imgs, labels, attrs

    # ------------------------------------------------------------- batches
    def _round_batches_device(self, idxs_users: Sequence[int]):
        """Per client a function ``step -> device batch`` gathering from its
        cache, and the clients' step counts; (None, None) when a client has
        no cache.  The host draws the sequential loader's
        ``np.random.permutation`` per client, in order, and ships the index
        matrices in one non-blocking copy.  A client with fewer samples than
        the batch trains one batch, cycled."""
        caches = [self._ensure_device_cache(i) for i in idxs_users]
        if any(c is None for c in caches):
            return None, None
        bs = self.cfg.DATALOADER.TRAIN_X.BATCH_SIZE
        idx_mats, n_steps = [], []
        for c in caches:
            n = int(c["label"].shape[0])
            perm = np.random.permutation(n)
            stop = (n // bs) * bs if n >= bs else n
            sel = perm[:stop]
            if stop < bs:
                sel = np.resize(sel, bs)
            steps = max(stop // bs, 1)
            idx_mats.append(sel.reshape(steps, bs))
            n_steps.append(steps)
        s_max = max(n_steps)
        mats = self._to_device(np.stack([
            np.concatenate([m_, np.repeat(m_[:1], s_max - m_.shape[0], axis=0)])
            for m_ in idx_mats]).astype(np.int64))  # [m, S, B]

        def stream(j, c):
            def batch(i):
                sel = mats[j, i]
                return {k: v.index_select(0, sel) for k, v in c.items()}
            return batch

        return [stream(j, c) for j, c in enumerate(caches)], n_steps

    def _round_batches(self, idxs_users: Sequence[int]):
        """The host path: every selected client's loader drained (in order,
        so the shuffles draw as the sequential loop's do), each batch padded
        to the batch size by cycling; an empty client trains zero steps."""
        bs = self.cfg.DATALOADER.TRAIN_X.BATCH_SIZE
        streams, n_steps = [], []
        for idx in idxs_users:
            batches = []
            for b in self.trainer.fed_train_loader_x_dict[idx]:
                batch = {"img": _pad_rows(np.asarray(b["img"]), bs),
                         "label": _pad_rows(np.asarray(b["label"], np.int64), bs)}
                if self._attr_col is not None:
                    batch["attr"] = _pad_rows(np.asarray(b["attrs"][:, self._attr_col],
                                                         np.int64), bs)
                batches.append(batch)
            streams.append(batches)
            n_steps.append(len(batches))
        if max(n_steps) == 0:
            raise ValueError(f"every selected client has an empty train set "
                             f"(clients {list(idxs_users)})")

        def stream(batches):
            return lambda i: {k: self._to_device(v) for k, v in batches[i].items()}

        return [stream(b) for b in streams], n_steps

    # ------------------------------------------------------------- round
    def run_round(self, epoch: int, idxs_users: Sequence[int], max_epoch: int,
                  mode: str = "ema_personal", test_users: Optional[Sequence[int]] = None,
                  fedprox_mu: Optional[float] = None,
                  eval_users: Optional[Sequence[int]] = None, deferred: bool = False):
        """Train the selected clients, aggregate, personalise (JAX
        parallel_driver.py:401-577).  ``mode``: ``ema_personal`` (FedOTPLoRA:
        EMA, group-weighted lora_S, shared_half_s, local prompt rows and
        lora_S kept for the clients in ``args.idxs_users_train``),
        ``fedavg`` (plain weighted average, no personalisation),
        ``prompt_personal`` (PromptFL/FedOTP: only the prompt rows
        ``[:avg_prompt]`` aggregate), ``local_personal`` (``local``: trained
        clients keep their state, the global is untouched) or
        ``fedavg_personal`` (FedOTPLinearFT: plain FedAvg, every test user
        keeping its own local prompt rows, and lora_S under LOCAL_S).  With
        ``eval_users`` the round's evaluation is enqueued too.  Returns the
        per-step metrics [m, S, 3] after the round's one fetch, or with
        ``deferred`` a handle for :meth:`resolve_round`, having made no
        blocking call once the caches are filled."""
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        idxs_users = [int(i) for i in idxs_users]
        m = len(idxs_users)
        trainer = self.trainer

        # the reference steps ONE shared scheduler per client-local epoch and
        # registered model name, so client j trains at lr(steps + j * mult)
        mult = getattr(trainer, "lr_step_multiplier", 1)
        lrs = [trainer.lr_sched.lr(trainer._lr_steps + j * mult) for j in range(m)]
        trainer._lr_steps += m * mult

        streams, n_steps = self._round_batches_device(idxs_users)
        if streams is None:
            streams, n_steps = self._round_batches(idxs_users)
        s_max = max(n_steps)
        step = self._local_step(fedprox_mu)
        ctx_global = (self.global_t["prompt_learner.ctx"].float()
                      if fedprox_mu is not None else None)
        zero = torch.zeros(3, device=self.device)
        trained_t, trained_o, metrics = [], [], []
        for j, idx in enumerate(idxs_users):  # one client after another, as on one TPU
            t, o = self._row(self.personal_t, idx), self._row(self.stacked_o, idx)
            ms = []
            for i in range(n_steps[j]):
                t, o, mt = step(t, o, streams[j](i), lrs[j], ctx_global)
                ms.append(mt)
            ms += [zero] * (s_max - n_steps[j])  # a ragged client's extra steps do not run
            trained_t.append(t)
            trained_o.append(o)
            metrics.append(torch.stack(ms))
        trained_t, trained_o = stack_clients(trained_t), stack_clients(trained_o)
        metrics = torch.stack(metrics)  # [m, S, 3]: loss, valid, acc (0 where no step ran)

        # aggregation weights (host scalars, fed/aggregate.py semantics)
        freqs, freqs_by_attr = _freqs(
            idxs_users, self.datanumber_client,
            self.datanumber_client_by_attr if mode == "ema_personal" else None)
        weights = self._to_device(np.asarray([freqs[i] for i in idxs_users], np.float32))
        group_w = None
        if freqs_by_attr is not None:
            gw = np.stack([freqs_by_attr[i] for i in idxs_users])
            # the observed histogram can be narrower than lora_S's group axis;
            # the reference then falls back to the client-weighted mean
            # (fed_utils.py:18-19)
            if gw.shape[1] == self.num_groups:
                group_w = self._to_device(gw.astype(np.float32))
        beta_decay = 0.999 * (epoch / max(max_epoch, 1))
        if not test_users:
            test_users = list(range(self.num_users))
        ts = set(int(i) for i in test_users)
        keep = [i in self.args.idxs_users_train and i in ts for i in idxs_users]
        idx_dev = self._to_device(np.asarray(idxs_users, np.int64))
        update_dev = self._to_device(np.asarray(list(test_users), np.int64))
        keep_dev = self._to_device(np.asarray(keep, bool))

        self.global_t, self.personal_t = self._aggregate(
            mode, trained_t, weights, group_w, beta_decay, idx_dev, update_dev, keep_dev)
        # trained clients keep their optimizer state across rounds
        self.stacked_o = {k: v.index_copy(0, idx_dev, trained_o[k].to(v.dtype))
                          for k, v in self.stacked_o.items()}

        # the round's evaluation, enqueued behind the aggregation
        pending = None
        if eval_users is not None:
            pending = self._eval_dispatch([int(i) for i in eval_users])
            if pending is not None:
                pending["epoch"] = epoch
        handle = {"epoch": epoch, "idxs_users": idxs_users, "lrs": lrs, "n_steps": n_steps,
                  "metrics": metrics, "pending_eval": pending}
        if deferred:
            return handle
        return self.resolve_round(handle)

    def resolve_round(self, handle):
        """The blocking half of a round: ONE fetch of the train metrics and
        the enqueued evaluation logits together, then the per-client lines.
        The fetched evaluation waits for :meth:`parallel_eval`."""
        pend = handle["pending_eval"]
        if pend is not None:
            ms, pend["logits_host"] = self._fetch(handle["metrics"], pend["logits"])
        else:
            (ms,) = self._fetch(handle["metrics"])
        self._pending_eval = pend
        for j, idx in enumerate(handle["idxs_users"]):
            nv = max(float(ms[j, :, 1].sum()), 1.0)
            print(f"client {idx}: steps {int(handle['n_steps'][j])} "
                  f"loss {ms[j, :, 0].sum() / nv:.4f} "
                  f"acc {ms[j, :, 2].sum() / nv:.4f} lr {handle['lrs'][j]:.6e}")
        return ms

    def _aggregate(self, mode, trained_t, weights, group_w, beta_decay, idx, update_idx, keep):
        """(new global, new personal states) for ``mode`` (JAX
        parallel_driver.py:627-786); the index and mask tensors are on the
        device."""
        ap = self.avg_prompt
        personal = self.personal_t

        if mode == "prompt_personal":
            # only the global prompt rows aggregate; everything else stays
            # per client (reference federated_main.py:447-485)
            ctx_key = next(k for k in trained_t if k.endswith("prompt_learner.ctx"))
            ctx = trained_t[ctx_key]
            w = weights.reshape((ctx.shape[0],) + (1,) * (ctx.dim() - 1))
            avg_rows = (ctx[:, :ap].float() * w).sum(0)
            new_global = dict(self.global_t)
            g = new_global[ctx_key].clone()
            g[:ap] = avg_rows.to(g.dtype)
            new_global[ctx_key] = g
            new_personal = {}
            for k, p in personal.items():
                tr = trained_t[k].to(p.dtype)
                if k == ctx_key:
                    out = p.clone()
                    out[:, :ap] = avg_rows.to(p.dtype)
                    sel = out.index_select(0, idx)
                    sel[:, ap:] = tr[:, ap:]
                    new_personal[k] = out.index_copy_(0, idx, sel)
                else:
                    new_personal[k] = p.index_copy(0, idx, tr)
            return new_global, new_personal

        if mode == "local_personal":
            return self.global_t, {k: p.index_copy(0, idx, trained_t[k].to(p.dtype))
                                   for k, p in personal.items()}

        avg = client_weighted_mean(trained_t, weights, group_w, self.num_groups)
        # the reference's shared_half_s sits inside its group-weighting guard
        # (fed_utils.py:91): no group weights, no sharing
        if self.shared_half_s and mode == "ema_personal" and group_w is not None:
            avg = apply_shared_half_s(avg, self.num_groups)
        if mode == "ema_personal":
            new_global = ema_blend(avg, self.global_t, beta_decay)
        else:
            new_global = {k: a.to(self.global_t[k].dtype) for k, a in avg.items()}

        def rows(state, at):
            return {k: v.index_select(0, at) for k, v in state.items()}

        def put(state, at, new_rows):
            return {k: v.index_copy(0, at, new_rows[k]) for k, v in state.items()}

        local_s = self.local_s  # ema_personal and fedavg_personal
        update_rows = rows(personal, update_idx)
        if mode == "fedavg_personal":
            # every test user takes the new global but keeps its own local
            # rows (and lora_S); the trained users then take this round's
            trained = {k: trained_t[k].to(p.dtype) for k, p in personal.items()}
            new_personal = put(personal, update_idx,
                               personalize(new_global, update_rows, ap, local_s))
            return new_global, put(new_personal, idx,
                                   personalize(rows(new_personal, idx), trained, ap, local_s))
        # the test users take the new global
        new_personal = put(personal, update_idx, {
            k: new_global[k].to(v.dtype).expand_as(v) for k, v in update_rows.items()})
        if mode == "fedavg":
            return new_global, new_personal
        trained = {k: trained_t[k].to(p.dtype) for k, p in personal.items()}
        # ema_personal: the kept clients (trained and tested) take this
        # round's local rows (and lora_S)
        cur = rows(new_personal, idx)
        kept = personalize(cur, trained, ap, local_s)
        mask = {k: keep.reshape((-1,) + (1,) * (v.dim() - 1)) for k, v in cur.items()}
        return new_global, put(new_personal, idx,
                               {k: torch.where(mask[k], kept[k], cur[k]) for k in cur})

    # ------------------------------------------------------------- eval
    def _eval_dispatch(self, idxs_users):
        """Enqueue every listed client's test logits over its device cache,
        each client padded to the same number of batches (the loader's
        pad-final rule within a client).  None when a client has no
        cache."""
        caches = [self._ensure_eval_cache(i) for i in idxs_users]
        if not caches or any(c is None for c in caches):
            return None
        has_attr = [c["attr_dev"] is not None for c in caches]
        if any(has_attr) and not all(has_attr):
            return None
        bs = self.cfg.DATALOADER.TEST.BATCH_SIZE
        mats, n_valids = [], []
        for c in caches:
            n = c["label"].shape[0]
            rows, valid = [], []
            for start in range(0, n, bs):
                chunk = np.arange(start, min(start + bs, n))
                valid.append(len(chunk))
                rows.append(np.resize(chunk, bs))
            mats.append(np.stack(rows))
            n_valids.append(valid)
        s_max = max(mat.shape[0] for mat in mats)
        padded = np.stack([np.concatenate([mat, np.repeat(mat[:1], s_max - mat.shape[0], axis=0)])
                           for mat in mats]).astype(np.int64)  # [m, S, bs]
        mats_dev = self._to_device(padded)
        with_attr = all(has_attr)
        logits = []
        for j, idx in enumerate(idxs_users):
            params = self._row(self.personal_t, idx)
            for row in range(s_max):
                sel = mats_dev[j, row]
                attr = caches[j]["attr_dev"].index_select(0, sel) if with_attr else None
                logits.append(self._infer(params, caches[j]["img"].index_select(0, sel), attr))
        logits = torch.stack(logits)
        return {"idxs": list(idxs_users), "caches": caches, "mats": mats, "n_valids": n_valids,
                "logits": logits.reshape((len(idxs_users), s_max) + tuple(logits.shape[1:]))}

    def parallel_eval(self, idxs_users: Sequence[int], current_epoch: int):
        """Evaluate the listed clients: the logits enqueued by this round's
        ``run_round`` (fetched by ``resolve_round``) or a new dispatch and one
        fetch, then each client's evaluator on the host; the output matches
        ``SimpleTrainer.test`` line for line.  None when a client has no
        device cache (the caller evaluates on the sequential path)."""
        idxs_users = [int(i) for i in idxs_users]
        pending = self._pending_eval
        if pending is not None and pending["idxs"] == idxs_users \
                and pending.get("epoch") == current_epoch:
            self._pending_eval = None
            ctx = pending
        else:  # never another round's logits under this round's label
            ctx = self._eval_dispatch(idxs_users)
        if ctx is None:
            return None
        logits = ctx.get("logits_host")
        if logits is None:
            (logits,) = self._fetch(ctx["logits"])
        trainer = self.trainer
        results = []
        for j, idx in enumerate(idxs_users):
            c, mat, valid = ctx["caches"][j], ctx["mats"][j], ctx["n_valids"][j]
            trainer.evaluator.reset()
            print(f"Evaluate on the client{idx}_test set")
            for row in range(mat.shape[0]):
                rows_idx = mat[row, :valid[row]]
                attrs_h = c["attrs"][rows_idx].T if c["attrs"] is not None else None
                trainer.evaluator.process(logits[j, row, :valid[row]], c["label"][rows_idx],
                                          attrs_h)
            res = trainer.evaluator.evaluate()
            for k, v in res.items():
                if np.isscalar(v):
                    trainer.write_scalar(f"test/{k}/{idx}", v, current_epoch)
            results.append(list(res.values()))
        return results

    # ------------------------------------------------------------- export
    def install_client(self, idx: int):
        """Copy client ``idx``'s state into the trainer (for the sequential
        evaluation and the final save)."""
        self.trainer.adopt_parallel_trainable(self._row(self.personal_t, int(idx)))

    def final_state_dict(self, idx: int) -> dict:
        self.install_client(idx)
        return self.trainer.state_dict()
