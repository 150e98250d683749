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
  (uint8 where the pixels are integral: SLO NPZs, CIFAR's NHWC arrays as
  loaded, X-rays already at the target size; fp32 where a resize made them
  fractional, as FedChexMimic's 320/336 -> 224) under one budget for the whole
  fleet, ``FAIRFEDMED_DEVICE_CACHE_BYTES`` (4 GiB by default); a round draws
  the sequential loader's ``np.random.permutation`` per client and gathers
  its batches on the device;
* aggregation and personalisation are PyTorch over the stacked clients
  (``fed/parallel.py``);
* ``run_round(..., deferred=True)`` only enqueues work: the host never waits
  for the device there once the caches are filled (round 0).
  ``resolve_round`` makes the round's one blocking fetch, the train
  metrics and the round's evaluation logits together;
* on a card, a local step whose batches come from the device caches is
  replayed from a CUDA graph (``train/graphed.py``; :func:`graphs_step`
  says which steps), captured in the first round that runs it.

With ``--resume DIR`` or ``FAIRFEDMED_ROUND_CKPT=<dir>`` (which wins) a
due round saves the whole federated state (global, stacked per-client
trainables and optimizer states, the LR step counter) as one checkpoint
``step_<epoch>`` of ``train/checkpoint.py`` and prunes this run's older
steps; a relaunch of the same run shape continues after the saved round
(``maybe_resume``).  Under deferral a round resolves after the next one has
been enqueued, so the round snapshots its own state into the handle: the
runner rebinds its tensors every round and never writes one in place.

The JAX package runs a round as one SPMD program over a device mesh.  Here
a round runs over the ranks of a ``torch.distributed`` group (one card per
rank under ``torchrun``, NCCL; or CPU processes, gloo), laid out as JAX's
(clients x data) mesh (``core/mesh.py``, one layout per round size, cached):
each client shard trains its contiguous clients one after another, each
data index its contiguous batch rows, the ranks of a shard summing their
gradients (the trainers' ``data_group``).  Then ONE ``all_gather`` of one
byte buffer per rank (its shard's trained state, optimizer state and
per-step metrics; the first rank of each shard counts, idle ranks send
zeros) gives every rank the round's stacked clients, and every rank runs
the same aggregation, so the state stays whole on every rank, as JAX's
replicated state.  A digest of the round (epoch, users, a checksum of the
new state), gathered and fetched with the metrics, raises where the ranks
diverged.  Every rank draws what the one-rank runner draws (each selected
client's permutation, or every selected loader drained on the host path),
makes the same cache decisions, and keeps only its own clients' batches;
rank 0 alone evaluates and writes the round checkpoints.  With one rank the
round is the one-card round, unchanged.

Intended differences from the sequential loop, as in the JAX package: each
client owns its optimizer state and keeps it across rounds (the sequential
loop steps every client through one optimizer, so the two agree only with
momentum-free SGD); under PromptFL/FedOTP the non-prompt trainables
(BatchNorm statistics included) stay per client; a client with fewer
samples than the batch trains one batch padded by cycling its samples.
"""

from __future__ import annotations

import os
import shutil
import zlib
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..core.mesh import build_mesh
from ..train.checkpoint import check_like, latest_step, load_pytree, save_pytree
from ..train.graphed import GraphedStep
from ..utils import profiling
from ..utils.profiling import span, stamp
from . import dist as fdist
from .aggregate import _freqs
from .parallel import (apply_shared_half_s, client_weighted_mean, ema_blend, personalize,
                       stack_clients)

CACHE_BYTES_ENV = "FAIRFEDMED_DEVICE_CACHE_BYTES"
ROUND_CKPT_ENV = "FAIRFEDMED_ROUND_CKPT"
MODES = ("ema_personal", "fedavg", "prompt_personal", "local_personal", "fedavg_personal")


class ForeignCheckpoint(ValueError):
    """A round checkpoint whose fingerprint is another run shape's."""


_INT_VIEW = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def _checksum(state: dict) -> torch.Tensor:
    """A positional checksum of the bits of ``state``'s tensors (int64, on
    their device; exact, so equal on ranks that hold equal bits)."""
    total = None
    for key in sorted(state):
        v = state[key].detach().contiguous().reshape(-1)
        bits = v.view(_INT_VIEW[v.element_size()]).long().remainder(65521)
        w = torch.arange(1, bits.numel() + 1, device=v.device).remainder(65521)
        part = (bits * w).remainder(65521).sum()
        total = part if total is None else total + part
    return total


def graphs_step(device, trainer, fedprox_mu=None, data_group=None) -> bool:
    """Whether the runner replays the local step of ``(fedprox_mu,
    data_group)`` from a CUDA graph: on a CUDA device, with no FedProx term
    (its global context changes per round) and no data group (its
    ``all_reduce``), where the trainer says the step makes no host
    synchronisation and has fixed shapes (``parallel_step_graphable``:
    GLP-OT without OT).  Rounds whose batches come from the host keep the
    eager step all the same (:meth:`ParallelRoundRunner._local_step`)."""
    return (torch.device(device).type == "cuda" and fedprox_mu is None and data_group is None
            and bool(getattr(trainer, "parallel_step_graphable", False)))


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
        self.world, self.rank = fdist.get_world_size(), fdist.get_rank()
        self._meshes = {}  # round size -> RankMesh

        # (fedprox mu, data group) -> step; the probe raises where unsupported
        self._steps = {(None, None): self._make_step(None, None)}
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
        self._train_host = {}  # client -> decoded train set not on this rank's device yet
        # ONE budget for every client's train and eval caches
        self._cache_budget = int(os.environ.get(CACHE_BYTES_ENV, 4 << 30))
        self._cached_bytes = 0
        self._pending_eval = None
        self.fetches = 0  # blocking device-to-host fetches made by resolve_round
        self._saved_steps = set()  # the step_N checkpoints this run wrote (or resumed)
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

    def _fetch(self, *tensors, round=None, line=None) -> list:
        """ONE blocking device-to-host transfer of ``tensors`` (floating ones
        as fp32, others as they are), moved as bytes: the ``fetch`` span of
        ``round``, with ``line`` its ``[timing]`` line."""
        parts = [t.float() if t.is_floating_point() else t for t in tensors]
        flat = torch.cat([p.contiguous().reshape(-1).view(torch.uint8) for p in parts])
        with span("fetch", round=round, line=line, bytes=flat.numel()):
            flat = flat.cpu().numpy()
        self.fetches += 1
        out, offset = [], 0
        for p in parts:
            n = p.numel() * p.element_size()
            np_type = torch.empty(0, dtype=p.dtype).numpy().dtype
            out.append(flat[offset:offset + n].view(np_type).reshape(tuple(p.shape)))
            offset += n
        return out

    def _mesh(self, m: int):
        """The round's rank grid for ``m`` clients (JAX
        parallel_driver.py:142-159), made once per round size."""
        if m not in self._meshes:
            self._meshes[m] = build_mesh(m, self.world, self.cfg.DATALOADER.TRAIN_X.BATCH_SIZE,
                                         getattr(self.trainer, "supports_data_axis", True),
                                         rank=self.rank)
        return self._meshes[m]

    def _make_step(self, fedprox_mu, data_group):
        step = self.trainer.make_parallel_local_step(fedprox_mu=fedprox_mu, data_group=data_group)
        if graphs_step(self.device, self.trainer, fedprox_mu, data_group):
            return GraphedStep(step, self.device)
        return step

    def _local_step(self, fedprox_mu, data_group=None, cached=True):
        """The step of ``(fedprox_mu, data_group)``; the eager one for a
        round whose batches come from the host (not ``cached``)."""
        key = (fedprox_mu, data_group)
        if key not in self._steps:
            self._steps[key] = self._make_step(fedprox_mu, data_group)
        step = self._steps[key]
        return step if cached else getattr(step, "eager", step)

    def _row(self, stacked: dict, idx: int) -> dict:
        return {k: v[idx] for k, v in stacked.items()}

    # ------------------------------------------------------------- device caches
    def _ensure_device_cache(self, idx: int, upload: bool = True) -> bool:
        """Whether client ``idx``'s train set has a device cache (see
        ``_decode_loader``).  The set is decoded once and counted against
        the budget on every rank, so every rank decides alike; it goes to the
        device when ``upload`` (the rank trains the client) and waits on the
        host until then."""
        if idx in self._data_cache:  # on the device, or refused (None)
            return self._data_cache[idx] is not None
        if idx not in self._train_host:
            stamp(f"device_cache:decode_start client={idx}")
            with span("cache.decode", client=idx):
                decoded = self._decode_loader(self.trainer.fed_train_loader_x_dict[idx])
            if decoded is None:
                self._data_cache[idx] = None
                return False
            stamp(f"device_cache:decode_done client={idx} ({decoded[0].nbytes >> 20} MiB)")
            self._cached_bytes += decoded[0].nbytes
            self._train_host[idx] = decoded
        if upload:
            imgs, labels, attrs = self._train_host.pop(idx)
            with span("cache.upload", client=idx, bytes=imgs.nbytes):
                cache = {"img": self._to_device(imgs),
                         "label": self._to_device(labels.astype(np.int64))}
                stamp(f"device_cache:push_done client={idx}")
                if self._attr_col is not None:
                    cache["attr"] = self._to_device(attrs[:, self._attr_col].astype(np.int64))
            self._data_cache[idx] = cache
        return True

    def _set_size(self, idx: int) -> int:
        held = self._train_host.get(idx)
        return len(held[1]) if held is not None else int(self._data_cache[idx]["label"].shape[0])

    def _ensure_eval_cache(self, idx: int):
        """Client ``idx``'s test set on the device (labels and attributes
        stay on the host for the evaluator), or None.  On a rank other than
        0, which never evaluates, the set is decoded and counted against the
        budget (rank 0's decisions stay every rank's) and dropped."""
        if idx in self._eval_cache:
            return self._eval_cache[idx]
        with span("cache.decode", client=idx):
            decoded = self._decode_loader(self.trainer.fed_test_loader_x_dict[idx])
        cache = None
        if decoded is not None:
            imgs, labels, attrs = decoded
            self._cached_bytes += imgs.nbytes
            with span("cache.upload", client=idx, bytes=imgs.nbytes if self.rank == 0 else 0):
                cache = {"img": self._to_device(imgs) if self.rank == 0 else None,
                         "label": labels, "attrs": attrs,
                         "attr_dev": (self._to_device(attrs[:, self._attr_col].astype(np.int64))
                                      if attrs is not None and self._attr_col is not None
                                      and self.rank == 0 else None)}
        self._eval_cache[idx] = cache
        return cache

    def _decode_loader(self, loader):
        """A client loader's whole dataset in index order as (imgs, labels,
        attrs), or None when it cannot be cached: a host transform (the
        images change per epoch), a structured sampler (its stream is not a
        permutation of the indices), no ``load_item``, an empty set, or a set
        that would take the fleet-wide cache (train and eval, every client)
        over its budget.  ``load_item_u8`` comes first; other integral fp32
        sets are stored as uint8, equal after the step's cast to float (JAX
        parallel_driver.py:198-313)."""
        ds = loader.dataset
        if (loader.transform is not None or getattr(loader, "sampler", None) is not None
                or not hasattr(ds, "load_item")):
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
                        stamp(f"device_cache:u8_fallback at item {i}/{n}")
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
    def _round_batches_device(self, idxs_users: Sequence[int], own=None, rows=slice(None)):
        """Per own client a function ``step -> device batch`` gathering its
        ``rows`` of each batch from its cache, and every client's step
        count; (None, None) when a client has no cache.  ``own``: the round
        positions this rank trains (all by default).  The host draws the
        sequential loader's ``np.random.permutation`` for every client, in
        order, and ships the own clients' index matrices in one non-blocking
        copy.  A client with fewer samples than the batch trains one batch,
        cycled."""
        own = range(len(idxs_users)) if own is None else own
        if not all([self._ensure_device_cache(i, upload=j in own)
                    for j, i in enumerate(idxs_users)]):
            return None, None
        bs = self.cfg.DATALOADER.TRAIN_X.BATCH_SIZE
        idx_mats, n_steps = [], []
        for i in idxs_users:
            n = self._set_size(i)
            perm = np.random.permutation(n)
            stop = (n // bs) * bs if n >= bs else n
            sel = perm[:stop]
            if stop < bs:
                sel = np.resize(sel, bs)
            steps = max(stop // bs, 1)
            idx_mats.append(sel.reshape(steps, bs))
            n_steps.append(steps)
        if not own:
            return [], n_steps
        s_max = max(n_steps)
        mats = self._to_device(np.stack([
            np.concatenate([m_, np.repeat(m_[:1], s_max - m_.shape[0], axis=0)])[:, rows]
            for m_ in (idx_mats[j] for j in own)]).astype(np.int64))  # [own, S, rows]

        def stream(jj, c):
            def batch(i):
                sel = mats[jj, i]
                return {k: v.index_select(0, sel) for k, v in c.items()}
            return batch

        return [stream(jj, self._data_cache[idxs_users[j]]) for jj, j in enumerate(own)], n_steps

    def _round_batches(self, idxs_users: Sequence[int], own=None, rows=slice(None)):
        """The host path: every selected client's loader drained (in order,
        so the shuffles and host transforms draw as the sequential loop's
        do, on every rank), each batch padded to the batch size by cycling;
        an empty client trains zero steps.  Streams of the own clients'
        ``rows`` only."""
        own = range(len(idxs_users)) if own is None else own
        bs = self.cfg.DATALOADER.TRAIN_X.BATCH_SIZE
        streams, n_steps = [], []
        for j, idx in enumerate(idxs_users):
            batches = []
            for b in self.trainer.fed_train_loader_x_dict[idx]:
                batch = {"img": _pad_rows(np.asarray(b["img"]), bs),
                         "label": _pad_rows(np.asarray(b["label"], np.int64), bs)}
                if self._attr_col is not None:
                    batch["attr"] = _pad_rows(np.asarray(b["attrs"][:, self._attr_col],
                                                         np.int64), bs)
                batches.append({k: v[rows] for k, v in batch.items()})
            if j in own:
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
        blocking call once the caches are filled.

        The round's phases are spans of ``utils/profiling.py``, tagged with
        ``epoch``; under ``FAIRFEDMED_TIMING=1`` rank 0 prints them as the
        JAX runner's phase lines, fenced as there.  The batches here are
        per-step streams, so on the host assembly path part of the assembly
        and of the copies runs inside the step loop.  ``round.batches``
        (``batch assembly``): the LR draws, the cache decode and upload
        calls, the permutations or the drained loaders, the index upload;
        ``round.device_put`` (``device_put``): the wait for those copies,
        printed only; ``round.train`` (``train program``): every own
        client's steps, each a ``step`` span with its batch gather (and a
        host batch's copies), holding a ``step.replay`` where the step is
        graphed (and a ``step.capture`` where it is captured);
        ``round.aggregate`` (``aggregate+scatter``):
        the gather over ranks, the aggregation and the optimizer-state
        scatter."""
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        idxs_users = [int(i) for i in idxs_users]
        profiling.read_timing_env()
        stamp(f"round:start epoch={epoch}")
        m = len(idxs_users)
        trainer = self.trainer

        with span("round.batches", round=epoch, line="batch assembly"):
            # the reference steps ONE shared scheduler per client-local epoch and
            # registered model name, so client j trains at lr(steps + j * mult)
            mult = getattr(trainer, "lr_step_multiplier", 1)
            lrs = [trainer.lr_sched.lr(trainer._lr_steps + j * mult) for j in range(m)]
            trainer._lr_steps += m * mult

            mesh = self._mesh(m)
            own, rows = mesh.own_clients, slice(None)
            if mesh.coord is not None and mesh.d > 1:
                rows = mesh.batch_rows(mesh.coord[1])
            streams, n_steps = self._round_batches_device(idxs_users, own, rows)
            cached = streams is not None
            if not cached:
                streams, n_steps = self._round_batches(idxs_users, own, rows)
        with span("round.device_put", round=epoch, line="device_put", fence=self.device):
            pass
        with span("round.train", round=epoch, line="train program", fence=self.device):
            s_max = max(n_steps)
            step = self._local_step(fedprox_mu, mesh.data_group, cached)
            ctx_global = (self.global_t["prompt_learner.ctx"].float()
                          if fedprox_mu is not None else None)
            zero = torch.zeros(3, device=self.device)
            trained_t, trained_o, metrics = [], [], []
            for jj, j in enumerate(own):  # a shard's clients one after another, as on one TPU
                idx = idxs_users[j]
                t, o = self._row(self.personal_t, idx), self._row(self.stacked_o, idx)
                ms = []
                for i in range(n_steps[j]):
                    with span("step"):
                        t, o, mt = step(t, o, streams[jj](i), lrs[j], ctx_global)
                    ms.append(mt)
                ms += [zero] * (s_max - n_steps[j])  # a ragged client's extra steps do not run
                trained_t.append(t)
                trained_o.append(o)
                metrics.append(torch.stack(ms))
        with span("round.aggregate", round=epoch, line="aggregate+scatter", fence=self.device):
            if self.world > 1:
                trained_t, trained_o, metrics = self._gather_round(mesh, trained_t, trained_o,
                                                                   metrics, s_max)
            else:
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

        digests = None
        if self.world > 1:  # every rank's digest of the round, fetched with the metrics
            digests = self._all_gather(self._digest(epoch, idxs_users))
        # the round's evaluation, enqueued behind the aggregation (rank 0
        # evaluates; the others make its cache decisions)
        pending = None
        if eval_users is not None and self.rank == 0:
            pending = self._eval_dispatch([int(i) for i in eval_users], epoch)
            if pending is not None:
                pending["epoch"] = epoch
        elif eval_users is not None:
            for i in eval_users:
                self._ensure_eval_cache(int(i))
        # round r's own state for its checkpoint: by the time a deferred
        # round resolves, self.* hold round r+1's tensors (new ones: nothing
        # here writes a state tensor in place)
        handle = {"epoch": epoch, "max_epoch": max_epoch, "idxs_users": idxs_users, "lrs": lrs,
                  "n_steps": n_steps, "metrics": metrics, "pending_eval": pending,
                  "digests": digests,
                  "state": (self.global_t, self.personal_t, self.stacked_o),
                  "lr_steps": int(trainer._lr_steps)}
        if deferred:
            return handle
        return self.resolve_round(handle)

    def resolve_round(self, handle):
        """The blocking half of a round: ONE fetch of the train metrics and
        the enqueued evaluation logits together, then the per-client lines,
        then the round checkpoint when one is due (its own one fetch).  The
        fetched evaluation waits for :meth:`parallel_eval`."""
        pend = handle["pending_eval"]
        digests = handle["digests"]
        fetched = self._fetch(handle["metrics"],
                              *([] if pend is None else [pend["logits"]]),
                              *([] if digests is None else [digests]),
                              round=handle["epoch"], line="metrics fetch")
        ms = fetched[0]
        if pend is not None:
            pend["logits_host"] = fetched[1]
        if digests is not None:
            self._check_digests(handle["epoch"], fetched[-1])
        self._pending_eval = pend
        for j, idx in enumerate(handle["idxs_users"]):
            nv = max(float(ms[j, :, 1].sum()), 1.0)
            print(f"client {idx}: steps {int(handle['n_steps'][j])} "
                  f"loss {ms[j, :, 0].sum() / nv:.4f} "
                  f"acc {ms[j, :, 2].sum() / nv:.4f} lr {handle['lrs'][j]:.6e}")
        # the config default CHECKPOINT_FREQ 0 means every round: setting a
        # checkpoint directory asks for preemption recovery
        epoch, max_epoch = handle["epoch"], handle["max_epoch"]
        ckpt_dir = self._round_ckpt_dir()
        if ckpt_dir and self.rank == 0:  # the state is the same on every rank
            freq = max(int(self.cfg.TRAIN.CHECKPOINT_FREQ), 1)
            if epoch + 1 >= max_epoch or (epoch + 1) % freq == 0:
                path = self.save_round_state(ckpt_dir, epoch, state=handle["state"],
                                             lr_steps=handle["lr_steps"])
                print(f"round state -> {path}")
                self._prune_round_ckpts(ckpt_dir, keep=epoch)
        return ms

    # ------------------------------------------------------------- several ranks
    def _all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """``[world, *t.shape]``: every rank's ``t``."""
        parts = [torch.empty_like(t) for _ in range(self.world)]
        dist.all_gather(parts, t.contiguous())
        return torch.stack(parts)

    def _gather_round(self, mesh, trained_t, trained_o, metrics, s_max):
        """The round's stacked ``[m]`` trainables, optimizer states and
        metrics on every rank, from ONE ``all_gather`` of one byte buffer per
        rank: its shard's clients, laid out as the state's leaves (checked
        against their dtypes), each piece padded to 16 bytes; idle ranks send
        zeros.  Shard ``i``'s rows come from its first rank, and the bytes
        come back exactly."""
        k = mesh.per_shard
        layout = ([("t", key, v.dtype, (k,) + tuple(v.shape[1:]))
                   for key, v in self.personal_t.items()]
                  + [("o", key, v.dtype, (k,) + tuple(v.shape[1:]))
                     for key, v in self.stacked_o.items()]
                  + [("m", "metrics", torch.float32, (k, s_max, 3))])
        sizes = [torch.Size(shape).numel() * torch.empty(0, dtype=dt).element_size()
                 for _, _, dt, shape in layout]
        padded = [-(-n // 16) * 16 for n in sizes]
        if mesh.coord is None:
            buf = torch.zeros(sum(padded), dtype=torch.uint8, device=self.device)
        else:
            own = {"t": stack_clients(trained_t), "o": stack_clients(trained_o),
                   "m": {"metrics": torch.stack(metrics)}}
            pieces = []
            for (part, key, dt, shape), n, pn in zip(layout, sizes, padded):
                v = own[part][key]
                if v.dtype != dt or tuple(v.shape) != shape:
                    raise TypeError(f"{part}:{key} is {v.dtype} {tuple(v.shape)}, the round "
                                    f"layout {dt} {shape}")
                pieces.append(v.contiguous().reshape(-1).view(torch.uint8))
                if pn > n:
                    pieces.append(torch.zeros(pn - n, dtype=torch.uint8, device=self.device))
            buf = torch.cat(pieces)
        gathered = self._all_gather(buf)
        out = {"t": {}, "o": {}, "m": {}}
        for part, key, dt, shape in layout:
            out[part][key] = []
        for i in range(mesh.c):
            row, offset = gathered[int(mesh.ranks[i, 0])], 0
            for (part, key, dt, shape), n, pn in zip(layout, sizes, padded):
                out[part][key].append(row[offset:offset + n].view(dt).reshape(shape))
                offset += pn
        cat = {part: {key: torch.cat(vs) for key, vs in d.items()} for part, d in out.items()}
        return cat["t"], cat["o"], cat["m"]["metrics"]

    def _digest(self, epoch: int, idxs_users) -> torch.Tensor:
        """int64 ``[5]`` on the device: the epoch, the number of users, a
        CRC of them, and a positional checksum (mod 65521) of the new global
        and per-client state's bits."""
        head = self._to_device(np.asarray(
            [epoch, len(idxs_users), zlib.crc32(",".join(map(str, idxs_users)).encode())],
            np.int64))
        return torch.cat([head, torch.stack([_checksum(self.global_t),
                                             _checksum(self.personal_t)])])

    def _check_digests(self, epoch: int, digests: np.ndarray) -> None:
        if not (digests == digests[:1]).all():
            raise RuntimeError(
                f"the ranks diverged in round {epoch}: per rank [epoch, users, users CRC, global "
                f"checksum, client checksum] = {digests.tolist()}")

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
    def _eval_dispatch(self, idxs_users, epoch=None):
        """Enqueue every listed client's test logits over its device cache,
        each client padded to the same number of batches (the loader's
        pad-final rule within a client): the ``round.eval_dispatch`` span of
        round ``epoch``.  None when a client has no cache."""
        with span("round.eval_dispatch", round=epoch, line="eval assemble+dispatch") as sp:
            stamp("eval:dispatch_start")
            caches = [self._ensure_eval_cache(i) for i in idxs_users]
            has_attr = [c is not None and c["attr_dev"] is not None for c in caches]
            if not caches or any(c is None for c in caches) or (any(has_attr)
                                                                and not all(has_attr)):
                sp.quiet()
                return None
            return self._eval_enqueue(idxs_users, caches, all(has_attr))

    def _eval_enqueue(self, idxs_users, caches, with_attr):
        """The evaluation's index upload and its per-batch logits, enqueued."""
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
            ctx = self._eval_dispatch(idxs_users, current_epoch)
        if ctx is None:
            return None
        with span("eval.logits", round=current_epoch, line="eval logits fetch"):
            logits = ctx.get("logits_host")
            if logits is None:
                (logits,) = self._fetch(ctx["logits"])
        trainer = self.trainer
        results = []
        with span("eval.host_metrics", round=current_epoch, line="eval host metrics"):
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

    # ------------------------------------------------------------- round checkpoints
    def _run_fingerprint(self) -> int:
        """The run shape a round checkpoint belongs to (JAX
        parallel_driver.py:977-993, the same CRC of the same key): users,
        model, trainer, backbone, dataset, modality and attribute."""
        key = "|".join([str(self.num_users), str(self.args.model), str(self.cfg.TRAINER.NAME),
                        str(self.cfg.MODEL.BACKBONE.NAME), str(self.cfg.DATASET.NAME),
                        str(self.cfg.DATASET.MODALITY_TYPE),
                        str(getattr(self.args, "attribute_type", ""))])
        return zlib.crc32(key.encode())

    def _run_fingerprint_legacy(self) -> int:
        """The fingerprint of checkpoints written before the dataset fields
        joined it (users, model, trainer, backbone); still accepted, with a
        note."""
        key = "|".join([str(self.num_users), str(self.args.model), str(self.cfg.TRAINER.NAME),
                        str(self.cfg.MODEL.BACKBONE.NAME)])
        return zlib.crc32(key.encode())

    def save_round_state(self, directory: str, epoch: int, state=None, lr_steps=None) -> str:
        """Write the federated state (global, stacked per-client trainables
        and optimizer states, the LR step counter) as ``step_<epoch>``, in
        one device-to-host fetch.  ``state`` / ``lr_steps`` default to the
        live ones; a deferred round passes its handle's snapshot."""
        g, p, o = state if state is not None else (self.global_t, self.personal_t,
                                                   self.stacked_o)
        tree = {"global_t": g, "personal_t": p, "stacked_o": o,
                "lr_steps": int(self.trainer._lr_steps if lr_steps is None else lr_steps),
                "epoch": int(epoch), "fingerprint": self._run_fingerprint()}
        path = save_pytree(directory, tree, step=epoch)
        self._saved_steps.add(epoch)
        return path

    def _prune_round_ckpts(self, directory: str, keep: int) -> None:
        """Delete the step_N checkpoints this run wrote or resumed, except
        ``keep``; another run's steps in a shared directory stay."""
        for step in list(self._saved_steps):
            if step != keep:
                shutil.rmtree(os.path.join(directory, f"step_{step}"), ignore_errors=True)
                self._saved_steps.discard(step)

    def _round_ckpt_dir(self):
        """``FAIRFEDMED_ROUND_CKPT``, else ``--resume DIR`` (cfg.RESUME), else
        None."""
        return os.environ.get(ROUND_CKPT_ENV) or (self.cfg.RESUME or None)

    def maybe_resume(self) -> int:
        """Restore the newest round checkpoint of the checkpoint directory and
        return the epoch to continue from (saved epoch + 1); 0 when there is
        none, or when it belongs to another run shape (ignored with a
        message).  A checkpoint of this run shape that does not load raises.
        The client sampling's RNG is not restored: a frac-sampled round
        after a resume draws afresh, as in the JAX package."""
        ckpt_dir = self._round_ckpt_dir()
        if not ckpt_dir:
            return 0
        step = latest_step(ckpt_dir)
        if step is None:
            return 0
        try:
            epoch = self.load_round_state(os.path.join(ckpt_dir, f"step_{step}"))
        except ForeignCheckpoint as e:
            print(f"ignoring round checkpoint {ckpt_dir}/step_{step}: {e}")
            return 0
        self._saved_steps.add(step)  # pruned after the next save
        print(f"resumed round state from {ckpt_dir}/step_{step} "
              f"(continuing at epoch {epoch + 1})")
        return epoch + 1

    def load_round_state(self, path: str) -> int:
        """Restore a :meth:`save_round_state` checkpoint onto the runner's
        device; returns its epoch.  Raises :class:`ForeignCheckpoint` for
        another run shape's fingerprint and ``ValueError`` when a checkpoint
        of this one does not match the state's keys, shapes or dtypes."""
        tree = load_pytree(path)
        fp = int(tree["fingerprint"])
        if fp != self._run_fingerprint():
            if fp != self._run_fingerprint_legacy():
                raise ForeignCheckpoint(
                    "round checkpoint belongs to a different run shape (users/model/trainer/"
                    "backbone or dataset/modality/attribute mismatch)")
            print("note: round checkpoint has a pre-dataset-identity fingerprint "
                  "(users/model/trainer/backbone match; dataset/modality/attribute "
                  "unverified) — resuming")
        template = {"global_t": self.global_t, "personal_t": self.personal_t,
                    "stacked_o": self.stacked_o, "lr_steps": 0, "epoch": 0, "fingerprint": 0}
        check_like(tree, template)
        dev = self.device
        self.global_t = {k: v.to(dev) for k, v in tree["global_t"].items()}
        self.personal_t = {k: v.to(dev) for k, v in tree["personal_t"].items()}
        self.stacked_o = {k: v.to(dev) for k, v in tree["stacked_o"].items()}
        self.trainer._lr_steps = int(tree["lr_steps"])
        return int(tree["epoch"])

    # ------------------------------------------------------------- export
    def install_client(self, idx: int):
        """Copy client ``idx``'s state into the trainer (for the sequential
        evaluation and the final save)."""
        self.trainer.adopt_parallel_trainable(self._row(self.personal_t, int(idx)))

    def final_state_dict(self, idx: int) -> dict:
        self.install_client(idx)
        return self.trainer.state_dict()
