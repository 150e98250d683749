"""A client-parallel local step replayed from a CUDA graph.

The eager step (``make_parallel_local_step``) launches every kernel of its
forward, backward and two optimizer updates from the host, 2263 launches a
ViT-B/16 step and 7222 an RN50 one, and the card waits on them.
:class:`GraphedStep` captures the step once per batch signature and then
replays it: a handful of launches a step, the same kernels on the same
inputs, so the same bits.

It stands where the runner keeps a step (``ParallelRoundRunner._steps``)
and keeps the step's contract: ``(params, opt_state, batch, lr,
ctx_global=None) -> (params, opt_state, metrics)``, new dicts on every call,
and no returned tensor written by a later call.

* **Static state.**  The parameters (with ResNet's ``__bn_stats__``) and
  the optimizer state live as views of one byte buffer
  (:class:`FlatLayout`), each leaf at a multiple of 512 bytes, as a fresh
  allocation of the caching allocator would be; the metrics in a static
  tensor of their own.  A call copies the state in (one
  ``torch._foreach_copy_`` per dtype) only when the dicts it is given are
  not the ones the previous call returned, and copies the buffer out once,
  whose views are the dicts returned, and the metrics apart: a caller that
  keeps every step's metrics keeps no copy of the state with them.
* **Capture.**  The first call of a batch signature (keys, shapes, dtypes)
  runs the eager step once on the caller's state (the layout takes its
  outputs' order), warms it up on a side stream on the static state, and
  captures the step followed by one copy of its new state (and metrics)
  into the static views, so the graph's inputs and outputs are one buffer.  No warm-up
  writes to any state: their results are dropped.  Graphs share one memory
  pool and the static state.
* **Every call.**  The batch is copied into the graph's static batch, the
  learning rate filled into a float32 device scalar
  (``FunctionalOptimizer.update`` multiplies float32 leaves by it as by the
  host float, so the same bits), one replay, two copies out.

On a device other than CUDA nothing is captured: the same plumbing runs
the eager step in place of the replay (the CPU tests).  Spans of
``utils/profiling.py``: ``step.capture`` around a capture with its
warm-ups, ``step.replay`` around each call's copies and replay.
"""

from __future__ import annotations

import math

import torch

from ..utils.profiling import span

ALIGN = 512  # bytes: where each leaf starts in the static buffer
WARMUP = 3  # eager runs before a capture: one on the caller's state, the rest on a side stream


def signature(tree: dict) -> tuple:
    """``(key, shape, dtype)`` of each leaf of ``tree``, in its order."""
    return tuple((k, tuple(v.shape), v.dtype) for k, v in tree.items())


class FlatLayout:
    """Where the leaves of named dicts of tensors lie in one byte buffer: one
    region per dtype, each leaf at a multiple of :data:`ALIGN` bytes.
    ``views(buf)`` gives the dicts, in their own key order, as views of
    ``buf``; ``groups`` lists per dtype the (tree, key) of its leaves."""

    def __init__(self, trees: dict):
        self.trees = {name: signature(tree) for name, tree in trees.items()}
        leaves = [(name, k, shape, dt) for name, sig in self.trees.items()
                  for k, shape, dt in sig]
        self.regions, self.groups, where = [], [], {}
        offset = 0
        for dt in dict.fromkeys(dt for *_, dt in leaves):
            item = torch.empty((), dtype=dt).element_size()
            members = [(name, k, shape) for name, k, shape, d in leaves if d == dt]
            sizes = []
            for i, (name, k, shape) in enumerate(members):
                numel = math.prod(shape)
                padded = -(-numel * item // ALIGN) * ALIGN // item
                sizes += [numel, padded - numel]
                where[(name, k)] = (len(self.regions), i, shape)
            end = offset + sum(sizes) * item
            self.regions.append((dt, offset, end, sizes))
            self.groups.append((dt, [(name, k) for name, k, _ in members]))
            offset = end
        self.nbytes = offset
        self._where = {name: [(k, *where[(name, k)]) for k, _, _ in sig]
                       for name, sig in self.trees.items()}

    def views(self, buf: torch.Tensor) -> dict:
        parts = [buf[start:end].view(dt).split_with_sizes(sizes)[::2]
                 for dt, start, end, sizes in self.regions]
        return {name: {k: parts[r][i].view(shape) for k, r, i, shape in where}
                for name, where in self._where.items()}


class _Graph:
    """One captured batch signature: its graph (None without capture), its
    static batch, and the eager runs its capture made and its replays."""

    def __init__(self, graph, batch, runs):
        self.graph, self.batch, self.runs, self.replays = graph, batch, runs, 0


class GraphedStep:
    """``step`` (a client-parallel local step) replayed from CUDA graphs on
    ``device``; the module's docstring says how.  ``eager`` is the step
    itself, for the rounds that keep it."""

    def __init__(self, step, device):
        self.eager = step
        self.device = torch.device(device)
        self.graphs = {}  # batch signature -> _Graph
        self.layout = None
        self._buf = self._static = self._metrics = self._lr = None
        self._holds = None  # the (params, opt_state) dicts whose values the static state holds
        self._stream = self._pool = None
        self.copies_in = 0

    def __call__(self, params, opt_state, batch, lr, ctx_global=None):
        if ctx_global is not None:
            raise ValueError("a graphed local step takes no FedProx global context")
        key = signature(batch)
        entry = self.graphs.get(key)
        if entry is None:
            with span("step.capture"):
                entry = self.graphs[key] = self._capture(params, opt_state, batch, lr)
        with span("step.replay"):
            self._load(params, opt_state)
            for k, v in batch.items():
                entry.batch[k].copy_(v)
            self._lr.fill_(lr)
            if entry.graph is None:
                self._body(entry.batch)
            else:
                entry.graph.replay()
            entry.replays += 1
            out = self.layout.views(self._buf.clone())
            metrics = self._metrics.clone()
        self._holds = (out["params"], out["opt"])
        return out["params"], out["opt"], metrics

    def _load(self, params, opt_state) -> None:
        """The static state takes ``params`` and ``opt_state`` unless it
        already holds them (the previous call's output)."""
        if self._holds is not None and params is self._holds[0] \
                and opt_state is self._holds[1]:
            return
        given = {"params": params, "opt": opt_state}
        for name, tree in given.items():
            if sorted(signature(tree), key=str) != sorted(self.layout.trees[name], key=str):
                raise ValueError(f"the graphed step's {name} leaves differ from the ones it "
                                 f"was captured with")
        for _, members in self.layout.groups:
            torch._foreach_copy_([self._static[name][k] for name, k in members],
                                 [given[name][k] for name, k in members])
        self._holds = (params, opt_state)
        self.copies_in += 1

    def _body(self, batch: dict) -> None:
        """The eager step on the static state, its new state and metrics
        copied back into the static tensors."""
        s = self._static
        new_p, new_o, metrics = self.eager(s["params"], s["opt"], batch, self._lr)
        new = {"params": new_p, "opt": new_o}
        for _, members in self.layout.groups:
            torch._foreach_copy_([s[name][k] for name, k in members],
                                 [new[name][k] for name, k in members])
        self._metrics.copy_(metrics)

    def _capture(self, params, opt_state, batch, lr) -> _Graph:
        """Lay out the static state (first call), then warm up and capture
        the step for ``batch``'s signature."""
        runs = 0
        if self.layout is None:
            new_p, new_o, metrics = self.eager(params, opt_state, batch, lr)
            runs += 1
            for name, given, out in (("params", params, new_p), ("opt", opt_state, new_o)):
                if sorted(signature(given), key=str) != sorted(signature(out), key=str):
                    raise ValueError(f"the step returns other {name} leaves than it takes")
            self.layout = FlatLayout({"params": new_p, "opt": new_o})
            self._buf = torch.zeros(self.layout.nbytes, dtype=torch.uint8, device=self.device)
            self._static = self.layout.views(self._buf)
            self._metrics = torch.zeros_like(metrics, memory_format=torch.contiguous_format)
            del new_p, new_o, metrics
            self._lr = torch.zeros((), dtype=torch.float32, device=self.device)
        self._load(params, opt_state)
        static_batch = {k: v.clone(memory_format=torch.contiguous_format)
                        for k, v in batch.items()}
        self._lr.fill_(lr)
        if self.device.type != "cuda":
            return _Graph(None, static_batch, runs)
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
            self._pool = torch.cuda.graph_pool_handle()
        current = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(current)
        with torch.cuda.stream(self._stream):
            s = self._static
            for _ in range(WARMUP - runs):
                self.eager(s["params"], s["opt"], static_batch, self._lr)
        current.wait_stream(self._stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool, stream=self._stream):
            self._body(static_batch)
        return _Graph(graph, static_batch, WARMUP + 1)
