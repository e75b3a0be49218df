"""Pipeline parallelism over point-to-point sends (counterpart of
``paddle_tpu/distributed/fleet/meta_parallel/pipeline_parallel.py``; ref:
fleet/meta_parallel/parallel_layers/pp_layers.py:257 PipelineLayer, :56
LayerDesc, :92 SegmentLayers; pipeline_parallel.py train_batch).

Segmentation and layout are the reference's. The body is the longest run
of structurally identical layers, cut to a multiple of S·V (S stages, V
virtual chunks a stage); the layers before it are the prologue, those
after it the epilogue. Logical chunk ``l = v·S + s`` runs on stage ``s``,
and its parameters are row ``s·V + v`` of the stacked parameters
``pipeline_stacked_{k}`` (``[S·V, ...]`` in the reference). Built outside
a pipeline topology, a ``PipelineLayer`` holds every row, as the
reference's does, and its ``forward`` runs the chunks in order on one
process. Built on a rank of a pp > 1 topology it holds only its stage:
its V rows (``[V, ...]``; ``utils.load_jax_params`` slices the
reference's whole arrays into them), the prologue only on the first
stage and the epilogue only on the last (Paddle's own placement; the
reference replicates them over pp, which on one process per rank would
cost a gradient sync of the embedding and the head a step). A
``SharedLayerDesc`` instance that lands on both the first and the last
stage has its gradient summed over those two.

The schedule. The reference is SPMD: one ``lax.scan`` of ticks with a ring
``lax.ppermute``, and autodiff derives the backward. The port runs one
process per rank and schedules the same ticks by hand
(:class:`PipelineParallel`): at tick ``t`` stage ``s`` computes ``n = t -
s``, chunk ``v = (n mod S·V) // S`` of microbatch ``m = (n // (S·V))·S +
(n mod S)``, and hands its output to the next stage (stage 0 of the next
chunk after the last stage) in one ``communication.ppermute`` over the pp
group, which every stage calls with the same pairs. The loss is taken once,
over the merged output: the last stage concatenates the M microbatches'
outputs, runs the epilogue and ``loss_fn`` on all of them, and backward
runs the ticks in reverse (what the transposed scan runs). A backward tick
is one ``torch.autograd.backward`` from that tick's ``ppermute`` output:
the ``ppermute``'s backward, with the pairs reversed, hands each stage the
gradient of what it sent, and the chunk's backward follows. This is not
1F1B (which would change what ``loss_fn`` sees).
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch
from torch import nn

__all__ = ["LayerDesc", "SharedLayerDesc", "SegmentLayers", "PipelineLayer",
           "PipelineParallel"]


class LayerDesc:
    """Lazy layer constructor (ref: pp_layers.py:56)."""

    def __init__(self, layer_cls, *inputs, **kwargs):
        self.layer_cls = layer_cls
        self.inputs = inputs
        self.kwargs = kwargs

    def build_layer(self):
        return self.layer_cls(*self.inputs, **self.kwargs)

    def __repr__(self):
        return f"LayerDesc({self.layer_cls.__name__})"


class SharedLayerDesc(LayerDesc):
    """Weight-tied layer (ref: pp_layers.py:76): every desc with the same
    ``key`` is one instance. ``forward_func`` and ``shared_weight_attr``
    are kept for parity; the instance is called as it is, as the
    reference calls it."""

    def __init__(self, key, layer_cls, *inputs, forward_func=None,
                 shared_weight_attr="weight", **kwargs):
        super().__init__(layer_cls, *inputs, **kwargs)
        self.layer_name = key
        self.forward_func = forward_func
        self.shared_weight_attr = shared_weight_attr


class SegmentLayers:
    """Split N layers into ``num_parts`` (ref: pp_layers.py:92)."""

    def __init__(self, layers, num_parts, method="uniform"):
        self.layers = layers
        self.num_parts = num_parts
        self.method = method

    def do_segment(self) -> List[int]:
        n = len(self.layers)
        if self.method == "uniform":
            base, rem = divmod(n, self.num_parts)
            bounds = [0]
            for i in range(self.num_parts):
                bounds.append(bounds[-1] + base + (1 if i < rem else 0))
            return bounds
        raise ValueError(f"unknown segment method {self.method}")


def _param_sig(layer: nn.Module):
    return tuple((name, tuple(p.shape), str(p.dtype))
                 for name, p in layer.named_parameters())


class PipelineLayer(nn.Module):
    """Pipeline-able model container (ref: pp_layers.py:257); ``layers`` is
    a list of modules and ``LayerDesc``s (see the module's docstring)."""

    def __init__(self, layers: Sequence, num_stages: Optional[int] = None,
                 topology=None, loss_fn: Optional[Callable] = None,
                 seg_method: str = "uniform", recompute_interval: int = 0,
                 num_virtual_pipeline_stages: int = 1, **kwargs):
        super().__init__()
        from ..base.topology import get_hybrid_communicate_group

        hcg = get_hybrid_communicate_group()
        pp = hcg.get_pipe_parallel_world_size() if hcg is not None else 1
        if num_stages is None:
            num_stages = pp
        V = int(num_virtual_pipeline_stages or 1)
        if V < 1:
            raise ValueError("num_virtual_pipeline_stages must be >= 1")
        if V > 1 and num_stages <= 1:
            V = 1  # interleaving is meaningless on a single stage
        # this process's stage on a pp > 1 topology; None: every stage
        self._stage = hcg.get_stage_id() if pp > 1 else None
        if self._stage is not None and num_stages != pp:
            raise ValueError(f"num_stages {num_stages} on a topology of "
                             f"pp_degree {pp}")
        self._num_stages = num_stages
        self._num_virtual = V
        self._loss_fn = loss_fn
        self._recompute_interval = recompute_interval
        self._topo = topology
        self._pp_elsewhere: List[str] = []  # names held by other stages

        shared: dict = {}  # SharedLayerDesc key -> instance (weight tying)
        built = []
        for d in layers:
            if isinstance(d, SharedLayerDesc):
                if d.layer_name not in shared:
                    shared[d.layer_name] = d.build_layer()
                built.append(shared[d.layer_name])
            elif isinstance(d, LayerDesc):
                built.append(d.build_layer())
            else:
                built.append(d)
        self._segment(built, list(shared.values()))
        self._stack_body()

    # -- segmentation --------------------------------------------------
    def _segment(self, built: List[nn.Module], shared: List[nn.Module]):
        S, V = self._num_stages, self._num_virtual
        L = S * V  # logical chunks
        sigs = [_param_sig(layer) for layer in built]
        best = (0, 0)  # (length, start) of the longest uniform run
        i = 0
        while i < len(built):
            if not sigs[i]:
                i += 1
                continue
            j = i
            while j < len(built) and sigs[j] == sigs[i]:
                j += 1
            if j - i > best[0]:
                best = (j - i, i)
            i = j
        run_len, start = best
        body_len = (run_len // L) * L if S > 1 else run_len
        if S > 1 and body_len == 0:
            raise ValueError(
                f"PipelineLayer: need a run of >= {L} structurally identical "
                f"layers to form {S} stages x {V} virtual chunks; longest "
                f"run is {run_len}")
        pre, post = built[:start], built[start + body_len:]
        body = built[start:start + body_len]
        # a shared instance in the prologue and the epilogue: two stages
        # hold it, and its gradient is summed over them
        self._shared_span = any(any(m is x for x in pre) and
                                any(m is x for x in post) for m in shared)
        self._shared_params: List[nn.Parameter] = []
        s = self._stage
        if s is not None:
            if s != 0:
                self._drop("_pre", pre)
                pre = []
            if s != S - 1:
                self._drop("_post", post)
                post = []
            if self._shared_span and s in (0, S - 1):
                held = pre if s == 0 else post
                for m in shared:
                    if any(m is x for x in held):
                        self._shared_params += list(m.parameters())
                if s != 0:  # counted once, on the first stage, by the clip
                    for p in self._shared_params:
                        p._pp_dup = True
        self._pre = nn.ModuleList(pre)
        self._post = nn.ModuleList(post)
        per = body_len // L if S > 1 else body_len
        self._chunk_groups = ([body[c * per:(c + 1) * per] for c in range(L)]
                              if S > 1 else [body])

    def _drop(self, attr: str, layers: List[nn.Module]):
        self._pp_elsewhere += [f"{attr}.{i}.{n}" for i, layer in
                               enumerate(layers)
                               for n, _ in layer.named_parameters()]

    # -- stacking ------------------------------------------------------
    def _stacked_index(self, chunk: int) -> int:
        """Logical chunk ``l = v*S + s`` lives at stacked row ``s*V + v``
        (ref: pp_layers.py get_stage_from_index)."""
        S, V = self._num_stages, self._num_virtual
        v, s = divmod(chunk, S)
        return s * V + v

    def _rows(self) -> List[int]:
        """The stacked rows this process holds, in order."""
        S, V = self._num_stages, self._num_virtual
        if self._stage is None:
            return list(range(S * V))
        return [self._stage * V + v for v in range(V)]

    def _stack_body(self):
        S, V = self._num_stages, self._num_virtual
        self._stacked: List[nn.Parameter] = []
        if S <= 1:
            self._body_layers = nn.ModuleList(self._chunk_groups[0])
            self._chunk_groups = None
            return
        L = S * V
        template = self._chunk_groups[0]
        names = [f"{i}.{n}" for i, layer in enumerate(template)
                 for n, _ in layer.named_parameters()]
        per_chunk = [[p for layer in grp for _, p in layer.named_parameters()]
                     for grp in self._chunk_groups]
        row_to_chunk = [0] * L
        for c in range(L):
            row_to_chunk[self._stacked_index(c)] = c
        rows = self._rows()
        for k, tp in enumerate(per_chunk[0]):
            stacked = torch.stack([per_chunk[row_to_chunk[j]][k].detach()
                                   for j in rows])
            param = nn.Parameter(stacked, requires_grad=tp.requires_grad)
            param.tp_axis = getattr(tp, "tp_axis", None)
            param.is_distributed = False
            if self._stage is not None:
                param._pp_rows = (self._stage, S)
            self.register_parameter(f"pipeline_stacked_{k}", param)
            self._stacked.append(param)
        # the stacked tensors are the parameters now: the template keeps
        # the chunk's structure with empty tensors (its forward runs on
        # the stacked rows through functional_call)
        for p in per_chunk[0]:
            p.data = torch.empty(0, dtype=p.dtype, device=p.device)
        object.__setattr__(self, "_template", nn.Sequential(*template))
        self._template_names = names
        self._num_layers_per_stage = len(template) * V
        self._chunk_groups = None

    def get_num_stages(self) -> int:
        return self._num_stages

    def train(self, mode: bool = True):
        super().train(mode)
        template = self.__dict__.get("_template")
        if template is not None:  # held outside the registered modules
            template.train(mode)
        return self

    # -- execution -----------------------------------------------------
    def _run_rows(self, i: int, x: torch.Tensor) -> torch.Tensor:
        """The template chunk on this process's stacked row ``i`` (on a
        stage, row ``v`` is its virtual chunk ``v``)."""

        def body(h):
            params = {n: st[i] for n, st in zip(self._template_names,
                                                self._stacked)}
            return torch.func.functional_call(self._template, params, (h,))

        if self._recompute_interval:
            from ..utils.recompute import recompute

            return recompute(body, x)
        return body(x)

    def _forward_body_sequential(self, h: torch.Tensor) -> torch.Tensor:
        if self._num_stages <= 1:
            for layer in self._body_layers:
                h = layer(h)
            return h
        for c in range(self._num_stages * self._num_virtual):
            h = self._run_rows(self._stacked_index(c), h)
        return h

    def forward(self, x):
        """Every chunk in order on this process (a ``PipelineLayer`` that
        holds every stage). A pipeline stage runs through
        ``PipelineParallel.train_batch`` / ``eval_batch``."""
        if self._stage is not None:
            raise RuntimeError(
                "this PipelineLayer holds one stage of a pp > 1 topology: run "
                "it through PipelineParallel's train_batch or eval_batch")
        h = x
        for layer in self._pre:
            h = layer(h)
        h = self._forward_body_sequential(h)
        for layer in self._post:
            h = layer(h)
        return h


# activation dtypes for the shape message of a schedule's first step
_DTYPES = [torch.float32, torch.bfloat16, torch.float16, torch.float64,
           torch.int64, torch.int32]


class PipelineParallel:
    """Runs the schedule (ref: pipeline_parallel.py:149, train_batch and
    eval_batch), one process per stage (see the module's docstring).

    With dp > 1 the stage is wrapped in ``DataParallel`` over the dp group
    (parameters broadcast from the group's first rank) and its gradients
    are averaged once a step, after the last backward tick (every earlier
    one runs under ``no_sync``); each dp rank passes its own part of the
    batch. ``train_batch`` runs eagerly: a CUDA graph cannot hold a gloo
    collective (ROADMAP C2). pp beside mp, sep or sharding raises."""

    def __init__(self, layers: PipelineLayer, hcg, strategy=None):
        if not isinstance(layers, PipelineLayer):
            raise TypeError("PipelineParallel expects a PipelineLayer")
        for what, n in (("mp", hcg.get_model_parallel_world_size()),
                        ("sep", hcg.get_sep_parallel_world_size()),
                        ("sharding", hcg.get_sharding_parallel_world_size())):
            if n > 1:
                raise NotImplementedError(
                    f"pipeline parallelism beside {what} ({what}_degree {n}) "
                    "is not ported yet: the pipeline runs beside dp only "
                    "(ROADMAP A1)")
        S = hcg.get_pipe_parallel_world_size()
        if layers._num_stages != S or (S > 1 and layers._stage is None):
            raise ValueError(
                f"the PipelineLayer has {layers._num_stages} stages built "
                f"outside this topology (pp_degree {S}): build it after "
                "fleet.init")
        self._layers = layers
        self._hcg = hcg
        self._strategy = strategy
        cfg = getattr(strategy, "pipeline_configs", {}) if strategy else {}
        self.accumulate_steps = int(cfg.get("accumulate_steps", 1))
        self._pp = hcg.get_pipe_parallel_group()
        self._shared_group = self._make_shared_group(hcg)
        self._dp = None
        dp = hcg.get_data_parallel_group()
        if dp is not None and dp.nranks > 1:
            from ...parallel import DataParallel

            self._dp = DataParallel(layers, group=dp)
        self._meta = {}
        self.hops = 0  # activations and gradients sent by this stage
        self.hop_bytes = 0

    def _make_shared_group(self, hcg):
        """The group of the first and the last stage, where a shared layer
        lands on both (every rank builds every such group, in one order)."""
        layers = self._layers
        if not layers._shared_span:
            return None
        if self._pp.nranks == 2:
            return self._pp
        from ...collective import new_group

        mine = None
        for ranks in hcg.topology().get_comm_list("pp"):
            g = new_group([ranks[0], ranks[-1]])
            if hcg.get_global_rank() in (ranks[0], ranks[-1]):
                mine = g
        return mine

    # -- the wrapper's plumbing -----------------------------------------
    def forward(self, *args, **kwargs):
        return self._layers(*args, **kwargs)

    __call__ = forward

    def parameters(self, include_sublayers=True):
        return self._layers.parameters(include_sublayers)

    def named_parameters(self, prefix="", include_sublayers=True):
        return self._layers.named_parameters(prefix, include_sublayers)

    def state_dict(self, *a, **k):
        return self._layers.state_dict(*a, **k)

    def set_state_dict(self, sd, *a, **k):
        return self._layers.load_state_dict(sd, *a, **k)

    def train(self):
        self._layers.train()
        return self

    def eval(self):
        self._layers.eval()
        return self

    # -- the schedule ----------------------------------------------------
    def _tick(self, s: int, t: int, M: int):
        """What stage ``s`` computes at tick ``t``: ``(v, m)`` or None."""
        S, V = self._layers._num_stages, self._layers._num_virtual
        n = t - s
        if n < 0:
            return None
        r = n % (S * V)
        m = (n // (S * V)) * S + r % S
        return (r // S, m) if m < M else None

    def _perm(self, t: int, M: int):
        """The hops of tick ``t``: ``(a, a + 1 mod S)`` for each stage that
        computes a chunk whose output another chunk takes."""
        S, V = self._layers._num_stages, self._layers._num_virtual
        perm = []
        for a in range(S):
            w = self._tick(a, t, M)
            if w is not None and not (a == S - 1 and w[0] == V - 1):
                perm.append((a, (a + 1) % S))
        return perm

    def _num_ticks(self, M: int) -> int:
        S, V = self._layers._num_stages, self._layers._num_virtual
        return ((M - 1) // S) * S * V + (V - 1) * S + (M - 1) % S + S

    def _broadcast_meta(self, t, src):
        """``t``'s shape and dtype on every stage of the pp group, sent by
        global rank ``src`` (which holds ``t``; the others pass None) as
        8 int64s: ndim, the index of the dtype in ``_DTYPES``, the shape."""
        from ...communication import broadcast

        msg = torch.zeros(8, dtype=torch.int64, device=self._pp.device)
        if t is not None:
            msg[0], msg[1] = t.dim(), _DTYPES.index(t.dtype)
            msg[2:2 + t.dim()] = torch.tensor(tuple(t.shape),
                                              device=msg.device)
        broadcast(msg, src=src, group=self._pp)
        n = int(msg[0])
        return tuple(int(d) for d in msg[2:2 + n]), _DTYPES[int(msg[1])]

    def _activation_meta(self, h, x):
        """The microbatch activation's shape and dtype on every stage: the
        first stage's, broadcast over the pp group once per input shape."""
        key = (tuple(x.shape), x.dtype)
        if key not in self._meta:
            self._meta[key] = self._broadcast_meta(h, self._pp.ranks[0])
        return self._meta[key]

    def _device(self):
        p = next(self._layers.parameters(), None)
        return p.device if p is not None else self._pp.device

    def _run(self, x, y, train: bool, compute_loss: bool = True):
        """The forward ticks, the loss on the last stage and (``train``)
        the backward ticks; returns the loss (or the logits) broadcast over
        the pp group."""
        from ...communication import broadcast, ppermute

        layers = self._layers
        S, s = layers._num_stages, layers._stage
        M = self.accumulate_steps
        last = s == S - 1
        if x.shape[0] % M:
            raise ValueError(f"batch of {x.shape[0]} does not split into "
                             f"accumulate_steps={M} microbatches")
        dev = self._device()
        h0 = h_leaf = feeds = None
        if s == 0:
            h0 = x
            for layer in layers._pre:
                h0 = layer(h0)
            h_leaf = h0.detach().requires_grad_(train)
            feeds = h_leaf.chunk(M, 0)
        shape, dtype = self._activation_meta(
            None if feeds is None else feeds[0], x)

        def dummy():
            return torch.zeros(shape, dtype=dtype, device=dev,
                               requires_grad=train)

        T = self._num_ticks(M)
        state = None
        outs, leaves, finals = {}, {}, {}
        for t in range(T):
            w = self._tick(s, t, M)
            y_t = None
            if w is not None:
                v, m = w
                inp = feeds[m] if (s == 0 and v == 0) else state
                y_t = layers._run_rows(v, inp)
                if last and v == layers._num_virtual - 1:
                    finals[m] = (t, y_t)
            perm = self._perm(t, M)
            if not perm:
                continue
            sender = any(a == s for a, _ in perm)
            src = y_t if sender else dummy()
            out = ppermute(src if train else src.detach(), perm,
                           group=self._pp)
            if sender:
                self._count_hop(y_t)
            outs[t] = out
            if any(b == s for _, b in perm):
                state = out.detach().requires_grad_(train)
                leaves[t + 1] = state

        loss = None
        if last:
            z = torch.cat([finals[m][1].detach() for m in range(M)]
                          ).requires_grad_(train)
            logits = z
            for layer in layers._post:
                logits = layer(logits)
            loss = layers._loss_fn(logits, y) if compute_loss else logits
            if train:
                loss.backward()
                d_final = z.grad.chunk(M, 0)
        if train:
            self._backward_ticks(T, M, outs, leaves, finals,
                                 d_final if last else None)
            if s == 0 and h0.requires_grad:  # the prologue's backward
                torch.autograd.backward(h0, h_leaf.grad)
        result = (loss.detach().float() if last
                  else torch.zeros((), dtype=torch.float32, device=dev))
        if not compute_loss:
            result = loss.detach() if last else None
            return self._broadcast_logits(result)
        broadcast(result, src=self._pp.ranks[-1], group=self._pp)
        return result

    def _count_hop(self, t: torch.Tensor):
        self.hops += 1
        self.hop_bytes += t.numel() * t.element_size()

    def _backward_ticks(self, T, M, outs, leaves, finals, d_final):
        """The ticks in reverse: from each tick's ``ppermute`` output with
        the next tick's input gradient (zeros where this stage received
        nothing), and from a final chunk's output with its share of the
        loss's gradient."""
        by_tick = {t: (m, d_final[m]) for m, (t, _) in finals.items()} \
            if d_final is not None else {}
        for t in range(T - 1, -1, -1):
            roots, grads = [], []
            if t in outs:
                nxt = leaves.get(t + 1)
                g = nxt.grad if nxt is not None else None
                roots.append(outs[t])
                grads.append(torch.zeros_like(outs[t]) if g is None else g)
                if g is not None:
                    self._count_hop(g)
            if t in by_tick:
                m, d = by_tick[t]
                roots.append(finals[m][1])
                grads.append(d)
            if roots:
                torch.autograd.backward(roots, grads)

    def _broadcast_logits(self, logits):
        from ...communication import broadcast

        src = self._pp.ranks[-1]
        shape, dtype = self._broadcast_meta(logits, src)
        if logits is None:
            logits = torch.empty(shape, dtype=dtype, device=self._device())
        broadcast(logits, src=src, group=self._pp)
        return logits

    def _sync_grads(self):
        """The shared layer's gradient summed over the first and the last
        stage, then the dp average (once a step)."""
        from ...communication import all_reduce

        if self._shared_group is not None:
            for p in self._layers._shared_params:
                if p.grad is not None:
                    all_reduce(p.grad, group=self._shared_group)
        if self._dp is not None:
            self._dp._sync_grads()

    def train_batch(self, data, optimizer, lr_scheduler=None, scaler=None):
        """One pipelined step over ``accumulate_steps`` microbatches (ref:
        pipeline_parallel.py train_batch): every stage passes the same
        ``(x, y)`` (its dp rank's part), and every rank returns the same
        loss, a device scalar (the mean of the dp ranks')."""
        from ...communication import all_reduce
        from ...collective import ReduceOp

        if scaler is not None:
            raise NotImplementedError(
                "PipelineParallel.train_batch with a GradScaler is not ported "
                "yet: its overflow check would need every stage (ROADMAP A1)")
        x, y = data
        if self._dp is not None:
            with self._dp.no_sync():
                loss = self._run(x, y, train=True)
        else:
            loss = self._run(x, y, train=True)
        self._sync_grads()
        optimizer.step()
        optimizer.clear_grad()
        if lr_scheduler is not None:
            lr_scheduler.step()
        if self._dp is not None:
            all_reduce(loss, op=ReduceOp.AVG, group=self._dp.group)
        return loss

    def eval_batch(self, data, compute_loss=True):
        """The forward ticks alone, without gradients (ref:
        pipeline_parallel.py eval_batch): the loss (or, without
        ``compute_loss``, the logits) on every stage."""
        from ...communication import all_reduce
        from ...collective import ReduceOp

        x, y = data
        with torch.no_grad():
            out = self._run(x, y, train=False, compute_loss=compute_loss)
        if compute_loss and self._dp is not None:
            all_reduce(out, op=ReduceOp.AVG, group=self._dp.group)
        return out
