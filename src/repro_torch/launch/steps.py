"""Production step builders and per-cell sharding rules (port of
``repro.launch.steps``).

``build_train_step``  — loss + gradients + the engine's projected-update
                        core (Adam + the l1,inf family projections,
                        warm-started: the theta state threads through the
                        step's signature), ``(params, opt, proj_state,
                        batch) -> (loss, metrics, params, opt,
                        proj_state)``; ``metrics`` carries the step's
                        Newton evaluations beyond the 2-evaluation floor.
``build_prefill_step``— the full forward, last-token logits.
``build_decode_step`` — one-token serve step against a cache; on a mesh
                        the cache stays in its pieces on the ranks (the
                        decode rules: sequence over "cache_seq", the SSM
                        state by heads, cross memory by heads) and is
                        written in place.

On the card a step runs every kernel of its path: the flash-attention and
SSD kernels forward and backward (bf16 or f32, the params' dtype), and,
under the engine's ``solver="fused"`` (``"fused_sharded"`` on a mesh), the
fused Adam+projection kernels for plans that stream their statistics at
``every_k == 1`` and the Newton for the rest. Params may be bf16 with f32
Adam moments (``AdamConfig(moment_dtype=torch.float32)``), the
reference's production setting; gradients take the params' dtype.

One device (``mesh=None``): the step updates ``params`` and ``opt`` in
place (the reference's jitted step donates them), so callers keep only
the returned trees. Its ``every_k`` gates run on the host: it reads the
optimizer count once a step, and a plan off its step is not solved.

On a (data, model) mesh (``launch.mesh``; every rank calls the step with
the same arguments): params and moments are ``DTensor``s holding each
rank's piece under ``param_shardings`` (the reference's layout, leaf for
leaf: FSDP over data, tensor parallel over model;
``convert.params_to_mesh``, ``shard_opt_state``) and the batch is the
global one, every rank's copy the same. Each rank takes its rows of the
batch (``shard``), each layer gathers its weights over data on entry
(``dist.sharding.gathered``; under remat the backward's recompute
gathers again), and every region runs on the rank's share (heads, kv
heads, MLA's heads, cross attention's heads, experts or their hidden
units, hidden units, vocab columns) with the explicit collectives of
``dist.sharding`` (counted by kind); an SSM whose inner width the model
axis splits through its heads gathers its pieces over model at use. The
engine's ``fused_sharded`` update runs on the gradients' pieces, so the
weights never gather for the projection: one (2, G) all-reduce per
Newton evaluation; a leaf the projection returns in its column layout
moves back to its spec's by one all-to-all (``train.loop.to_specs``).
The loss is the global one on every rank. On a one-rank mesh the engine
is the one-device one, and it runs on the pieces.

``lower_cell`` (the dry-run's) builds a cell's step from these builders
on meta tensors and runs it once under ``roofline.counter.Counter``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional

import torch

from .._device import host_int
from .._tree import flatten_with_path, leaves, tree_map, unflatten_like
from ..core import ProjectionEngine
from ..dist.sharding import (Spec, axes_index, axis_rules, default_rules,
                             fit_spec, logical_spec, placements)
from ..models.zoo import SHAPES, Model
from ..optim import AdamConfig
from ..optim.adam import AdamState
from ..train.loop import (_grad_tree, local_batch, mesh_loss_and_grads,
                          mesh_weights, to_specs_state)

__all__ = ["projection_engine_for", "build_train_step", "build_prefill_step",
           "build_decode_step", "rules_for_cell", "batch_shardings",
           "cache_shardings", "param_shardings", "opt_shardings",
           "shard_opt_state", "cell_step", "lower_cell", "LoweredCell"]


# ---------------------------------------------------------------------------
# rules and shardings
# ---------------------------------------------------------------------------

def rules_for_cell(cfg, shape_name: str, multi_pod: bool) -> dict:
    """The reference's per-cell rules: train / prefill take
    ``default_rules``; decode moves the model axis onto the KV-cache
    sequence (batch 1: every axis); then ``cfg.rules_overrides``."""
    sh = SHAPES[shape_name]
    rules = default_rules(multi_pod=multi_pod)
    if sh["kind"] == "decode":
        if sh["batch"] == 1:
            rules["batch"] = None
            rules["cache_batch"] = None
            rules["cache_seq"] = (("pod", "data", "model") if multi_pod
                                  else ("data", "model"))
            rules["kv_heads"] = None
        else:
            rules["cache_seq"] = "model"
            rules["kv_heads"] = None
    rules.update(dict(cfg.rules_overrides))
    return rules


def batch_shardings(batch: Dict[str, Any], mesh, rules: dict):
    """The ``Spec`` of each batch leaf: tokens / labels (B, S), frames /
    image_embeds (B, S, d); batch over ``rules["batch"]`` fit to the
    mesh."""
    b = rules["batch"]
    return {k: fit_spec(mesh, (b,) + (None,) * (v.ndim - 1), tuple(v.shape))
            for k, v in batch.items()}


def cache_shardings(cache, mesh, rules: dict):
    """The ``Spec`` of each decode-cache leaf, by leaf name (stacked leaves
    under ``blocks`` carry a leading layer dim, never sharded); every dim
    fit to the mesh."""
    cb, cs = rules["cache_batch"], rules["cache_seq"]

    def one(path, leaf):
        name = path.rsplit("/", 1)[-1]
        if name in ("k", "v"):
            axes = [cb, cs, rules.get("kv_heads"), None]
        elif name in ("ck", "cv"):
            axes = [cb, None, rules.get("heads"), None]
        elif name in ("c", "kr"):
            axes = [cb, cs, None]
        elif name == "state":
            axes = [cb, rules.get("mlp"), None, None]
        elif name.startswith("conv"):
            axes = [cb, None, None]
        else:
            axes = [None] * leaf.ndim
        if leaf.ndim == len(axes) + 1:
            axes = [None] + axes
        return fit_spec(mesh, axes, tuple(leaf.shape))

    flat = flatten_with_path(cache)
    return unflatten_like(cache, [one(p, l) for p, l in flat])


def param_shardings(model: Model, mesh, rules: dict):
    """The ``Spec`` of every param leaf on ``mesh``: the reference's
    ``model.param_specs(rules)`` fit to the mesh (``fit_spec``: a dim an
    axis does not divide replicates), leaf for leaf. Whether a region
    computes split over model follows from its pieces, in the model code:
    heads, kv heads, experts and hidden units split over model compute on
    the rank's share (``models.attention``, ``models.moe``), and an SSM
    whose inner width splits through its heads gathers its pieces over
    model at use (``models.ssm``)."""
    return tree_map(lambda pm: fit_spec(
        mesh, [rules.get(a) if a is not None else None for a in pm.axes],
        pm.shape), model.layout)


def opt_shardings(param_sh, mesh):
    """``AdamState`` of specs: the count replicated, the moments as their
    params."""
    return AdamState(count=Spec(), mu=param_sh, nu=param_sh)


def shard_opt_state(params, acfg: AdamConfig = AdamConfig()) -> AdamState:
    """Zero Adam moments (``acfg.moment_dtype``) laid out as ``params``
    (``DTensor``s over one mesh, each rank's piece zeroed); the count on
    the pieces' device."""
    from ..dist.layout import MeshLayout, wrap

    def zeros(p):
        local = torch.zeros(p.to_local().shape, dtype=acfg.moment_dtype,
                            device=p.to_local().device)
        return wrap(local, p.shape, tuple(p.placements),
                    MeshLayout(p.device_mesh))

    first = leaves(params)[0].to_local()
    return AdamState(count=torch.zeros((), dtype=torch.int32,
                                       device=first.device),
                     mu=tree_map(zeros, params), nu=tree_map(zeros, params))


@dataclasses.dataclass
class LoweredCell:
    """One traced cell: its step's ``kind`` ("train", "prefill",
    "decode"), the ``Counts`` of one run of it on meta tensors (rank 0's
    view), the bytes of the step's outputs that are not its arguments
    (a train step's updated state, the logits, a decode step's cache are
    written in place on one device), and the bytes of its arguments'
    pieces, each counted once (what ``counts.argument_bytes``, from their
    storages, must equal)."""
    kind: str
    counts: Any
    output_bytes: int = 0
    pieces_bytes: int = 0


def _meta_tokens(batch):
    """The cell's int32 token ids as the port's batches carry them
    (int64, ``make_batch`` / ``LMBatcher``); other leaves as given."""
    return {k: v.to(torch.int64) if k in ("tokens", "labels") else v
            for k, v in batch.items()}


def cell_step(model: Model, shape_name: str, mesh, multi_pod: bool,
              dtype: torch.dtype = torch.bfloat16,
              with_projection: bool = True,
              extra_rules: Optional[dict] = None):
    """(kind, step, args) of one (arch x shape x mesh) cell on meta
    tensors, nothing allocated: the cell's step from this module's
    builders under ``rules_for_cell`` (with ``extra_rules``), and its
    arguments, ``abstract_params`` (``dtype``), the zoo's ``input_specs``
    and, for a train step, f32 Adam moments and the engine's theta state;
    on ``mesh`` (a ``DeviceMesh`` over a process group, e.g. the
    dry-run's fake one) the params, moments and cache are this rank's
    pieces under their specs, each in storage of its own."""
    from .. import convert
    from ..models.zoo import input_specs
    from ..optim import adam_init

    cfg = model.cfg
    sh = SHAPES[shape_name]
    rules = rules_for_cell(cfg, shape_name, multi_pod)
    if extra_rules:
        rules.update(extra_rules)
    params = model.abstract_params(dtype)
    if mesh is not None:
        params = convert.params_to_mesh(
            params, mesh, param_shardings(model, mesh, rules), device="meta")
    specs = input_specs(cfg, shape_name, dtype)

    if sh["kind"] == "train":
        acfg = AdamConfig(moment_dtype=torch.float32)
        opt = (adam_init(params, acfg) if mesh is None
               else shard_opt_state(params, acfg))
        proj = projection_engine_for(cfg, mesh, with_projection).init_state(
            params)
        step = build_train_step(model, mesh, rules, acfg,
                                with_projection=with_projection)
        return "train", step, (params, opt, proj, _meta_tokens(specs))
    if sh["kind"] == "prefill":
        return "prefill", build_prefill_step(model, mesh, rules), (
            params, _meta_tokens(specs))
    cache = specs["cache"]
    if mesh is not None:
        cache = convert.cache_to_mesh(
            cache, mesh, cache_shardings(cache, mesh, rules), device="meta")
    step = build_decode_step(model, mesh, rules)
    return "decode", step, (params, cache, _meta_tokens(specs)["tokens"],
                            specs["pos"])


def lower_cell(model: Model, shape_name: str, mesh, multi_pod: bool,
               dtype: torch.dtype = torch.bfloat16,
               with_optimizer: bool = True, with_projection: bool = True,
               extra_rules: Optional[dict] = None) -> LoweredCell:
    """Trace one (arch x shape x mesh) cell on meta tensors: nothing is
    allocated. The cell's step and arguments come from ``cell_step``; the
    step runs once under a ``roofline.counter.Counter`` (its arguments
    live from the start); returns its kind and counts. ``with_optimizer``
    is the reference's argument, which its body does not read either: a
    train step always carries Adam."""
    from ..roofline.counter import Counter

    kind, step, args = cell_step(model, shape_name, mesh, multi_pod, dtype,
                                 with_projection, extra_rules)
    with Counter(arguments=args) as counter:
        out = step(*args)
    held = {t.untyped_storage()._cdata for t in _locals(args)}
    fresh = {t.untyped_storage()._cdata: t.untyped_storage().nbytes()
             for t in _locals(out)}
    return LoweredCell(kind, counter.counts,
                       sum(n for k, n in fresh.items() if k not in held),
                       sum(t.numel() * t.element_size()
                           for t in _locals(args)))


def _locals(tree):
    """The plain tensors of a tree of dicts, tuples and named tuples (a
    ``DTensor``'s piece)."""
    from torch.utils._pytree import tree_leaves
    return [getattr(t, "_local_tensor", t) for t in tree_leaves(tree)
            if isinstance(t, torch.Tensor)]


def projection_engine_for(cfg, mesh=None,
                          with_projection: bool = True) -> ProjectionEngine:
    """The production engine policy: the fused two-pass step wherever it
    exists. On a mesh of more than one rank that is
    ``solver="fused_sharded"``: the fused passes on each rank's column
    block, one (2, num_segments) all-reduce per Newton evaluation, and the
    mesh-resident Newton of ``solver="sharded"`` for plans the fused step
    cannot take. With no mesh, or one rank, it is ``solver="fused"`` with
    the single-buffer Newton as the fallback."""
    specs = cfg.projection_specs if with_projection else ()
    if mesh is not None and mesh.size() > 1:
        return ProjectionEngine(specs, solver="fused_sharded", mesh=mesh)
    return ProjectionEngine(specs, solver="fused")


def _next_count(opt_state) -> Optional[int]:
    """The step's new optimizer count read on the host, so that the
    every_k gates run there; None on meta (``host_int``): the count stays
    on the device and every gate fires."""
    count = host_int(opt_state.count)
    return None if count is None else count + 1


def _extra_evals(stats: Dict[str, Any], device) -> torch.Tensor:
    """Eq.-(19) evaluations beyond the 2-evaluation bootstrap floor, the
    largest over the plans solved this step (0 when none was)."""
    if not stats:
        return torch.zeros((), dtype=torch.int32, device=device)
    return torch.stack([torch.as_tensor(v, device=device).to(torch.int32) - 2
                        for v in stats.values()]).max()


# ---------------------------------------------------------------------------
# the steps over a mesh
# ---------------------------------------------------------------------------

def _whole(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The full tensor on every rank from this rank's piece under ``spec``
    (one ``layout.move`` to replicated)."""
    from ..dist.layout import MeshLayout, move, replicated_placements
    from ..dist.sharding import _global_shape
    lay = MeshLayout(mesh)
    return move(x.contiguous(), _global_shape(x.shape, spec, mesh),
                placements(mesh, spec), replicated_placements(lay), lay)


def _one_rank_update(engine, grads, opt_state, params, acfg, **kw):
    """``engine.projected_update`` on a one-rank mesh: the engine is the
    one-device one (``projection_engine_for``), whose solvers take plain
    tensors, so it runs on the pieces (each its whole leaf) and the
    results go back as ``DTensor``s laid out as their inputs."""
    from ..dist.layout import MeshLayout, local_of, wrap
    pieces = lambda t: tree_map(local_of, t)
    like = lambda t, ref: tree_map(lambda x, r: wrap(
        x, r.shape, tuple(r.placements), MeshLayout(r.device_mesh)), t, ref)
    new_p, new_o, new_proj, stats = engine.projected_update(
        pieces(grads), AdamState(count=opt_state.count,
                                 mu=pieces(opt_state.mu),
                                 nu=pieces(opt_state.nu)),
        pieces(params), acfg, **kw)
    return (like(new_p, params),
            AdamState(count=new_o.count, mu=like(new_o.mu, opt_state.mu),
                      nu=like(new_o.nu, opt_state.nu)), new_proj, stats)


def _mesh_train_step(model: Model, mesh, rules: dict, acfg: AdamConfig,
                     with_projection: bool):
    engine = projection_engine_for(model.cfg, mesh, with_projection)
    specs = param_shardings(model, mesh, rules)

    def train_step(params, opt_state, proj_state, batch):
        with axis_rules(mesh, rules):
            loss, metrics, grads = mesh_loss_and_grads(model, params, specs,
                                                       batch, mesh)
            with torch.no_grad():
                update = (engine.projected_update if engine.mesh is not None
                          else functools.partial(_one_rank_update, engine))
                new_params, new_opt, new_proj, stats = update(
                    grads, opt_state, params, acfg, state=proj_state,
                    with_stats=True, count=_next_count(opt_state))
                new_params, new_opt = to_specs_state(new_params, new_opt,
                                                     specs, mesh)
        metrics["proj_newton_extra_evals"] = _extra_evals(stats, loss.device)
        return loss, metrics, new_params, new_opt, new_proj

    return train_step


def build_train_step(model: Model, mesh=None, rules: Optional[dict] = None,
                     acfg: AdamConfig = AdamConfig(),
                     with_projection: bool = True):
    """The production train step: ``train_step(params, opt_state,
    proj_state, batch) -> (loss, metrics, params, opt_state, proj_state)``
    with ``metrics["proj_newton_extra_evals"]`` beside the loss's own
    metrics. With no mesh ``params`` and ``opt_state`` are updated in
    place; on a mesh (``rules``: e.g. ``rules_for_cell``) they are
    ``DTensor``s under ``param_shardings`` and come back as new ones, and
    the loss is the global one on every rank."""
    if mesh is not None:
        return _mesh_train_step(model, mesh, rules or default_rules(), acfg,
                                with_projection)
    engine = projection_engine_for(model.cfg, None, with_projection)

    def train_step(params, opt_state, proj_state, batch):
        grads = tree_map(torch.zeros_like, params)
        leaves = _grad_tree(params, grads)
        loss, metrics = model.loss(leaves, batch)
        loss.backward()
        del leaves
        loss = loss.detach()
        metrics = {k: v.detach() for k, v in metrics.items()}
        with torch.no_grad():
            new_params, new_opt, new_proj, stats = engine.projected_update(
                grads, opt_state, params, acfg, state=proj_state,
                with_stats=True, count=_next_count(opt_state),
                inplace=True)
        metrics["proj_newton_extra_evals"] = _extra_evals(stats, loss.device)
        return loss, metrics, new_params, new_opt, new_proj

    return train_step


def build_prefill_step(model: Model, mesh=None,
                       rules: Optional[dict] = None):
    """``prefill_step(params, batch) -> logits (B, V)`` of the last token.
    On a mesh: params as ``build_train_step``'s, the global batch; each
    rank runs the forward on its rows, heads and vocab columns, and the
    logits come back whole on every rank (one ``layout.move``)."""
    if mesh is None:
        @torch.no_grad()
        def prefill_step(params, batch):
            logits, _ = model.forward(params, batch)
            return logits[:, -1, :]

        return prefill_step
    rules = rules or default_rules()
    specs = param_shardings(model, mesh, rules)
    vocab = specs["embed"]["table"][0]

    @torch.no_grad()
    def mesh_prefill_step(params, batch):
        with axis_rules(mesh, rules):
            _, tree = mesh_weights(params, specs, grad=False)
            local = local_batch(batch)
            logits, _ = model.forward(tree, local)
            b = batch_shardings(batch, mesh, rules)["tokens"][0]
            return _whole(logits[:, -1, :], Spec(b, vocab), mesh)

    return mesh_prefill_step


def _rows(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """This rank's block of ``x``'s rows over mesh ``axes`` (a local
    slice; every rank holds all of ``x``)."""
    index, ways = axes_index(mesh, axes)
    n = x.shape[0] // ways
    return x[index * n:(index + 1) * n]


def _cache_pieces(cache, c_specs, mesh):
    """This rank's piece of every cache leaf (the tensors the step writes
    in place), after checking that each is laid out under its spec."""
    from ..dist.layout import MeshLayout, local_of, placements_of
    lay = MeshLayout(mesh)

    def one(x, spec):
        want = placements(mesh, spec)
        if not hasattr(x, "placements") or placements_of(x, lay) != want:
            raise ValueError(
                f"build_decode_step: a cache leaf of shape {tuple(x.shape)} "
                f"is not laid out under its spec {spec} (lay the cache out "
                f"with convert.cache_to_mesh(cache, mesh, "
                f"cache_shardings(cache, mesh, rules)))")
        return local_of(x)

    return tree_map(one, cache, c_specs)


def _seq_axes(c_specs):
    """The mesh axes that split the sequence of the position-indexed cache
    leaves (k / v, c / kr: dim 1, or 2 when layer-stacked), or None."""
    for path, spec in flatten_with_path(c_specs):
        if path.rsplit("/", 1)[-1] in ("k", "v", "c", "kr"):
            return spec[2 if path.startswith("blocks/") else 1]
    return None


def _batch_axes(c_specs):
    """The mesh axes that split the cache's rows (dim 0, or 1 when
    layer-stacked) of any of its leaves."""
    for path, spec in flatten_with_path(c_specs):
        return spec[1 if path.startswith("blocks/") else 0]
    return None


def build_decode_step(model: Model, mesh=None,
                      rules: Optional[dict] = None):
    """``serve_step(params, cache, tokens, pos) -> (logits (B, V), cache)``
    against a KV cache.

    One device (``mesh=None``): the new cache is a copy; the cache passed
    in is left as it was.

    On a mesh (every rank calls the step with the same arguments), under
    ``rules`` (the reference's decode rules, ``rules_for_cell(cfg,
    "decode_32k" | "long_500k", ...)``, or the train rules): params as
    ``build_train_step``'s (``DTensor``s under ``param_shardings``: each
    layer's FSDP gathers over data each call, ``fsdp_gather``, and the
    tensor-parallel regions split over model; where the cache's sequence
    takes the model axis, an attention layer's head-split weights are
    gathered over model, ``decode_head_gather``); ``cache`` the
    ``DTensor`` pieces under ``cache_shardings``
    (``convert.cache_to_mesh``), which live on their ranks between calls
    and which the step writes in place (the reference donates the
    cache), never gathered, moved or sliced;
    ``tokens`` (B, 1) and ``pos`` (a scalar or (B,)) the global ones,
    every rank's copy the same. Each rank decodes its rows (the rules'
    "batch") against its pieces: a cache sequence split over
    "cache_seq" is combined by one MAX and one SUM over those axes per
    attention layer (``decode_max``, ``decode_sum``: the split-softmax,
    ``models.attention``), the SSM state and its weights by whole heads
    over model, cross attention's memory by heads over model. Returns the
    logits as a ``DTensor`` under the reference's out-sharding
    ``logical_spec(("batch", "vocab"))`` (each rank its rows and vocab
    columns) and the same cache tree, updated."""
    if mesh is None:
        @torch.no_grad()
        def serve_step(params, cache, tokens, pos):
            logits, new_cache = model.decode(params, cache, tokens, pos)
            return logits[:, -1, :], new_cache

        return serve_step
    from ..dist.layout import MeshLayout, wrap
    from ..models.attention import pos_tensor
    from ..models.transformer import decode_step_
    rules = dict(rules or default_rules())
    specs = param_shardings(model, mesh, rules)
    table = "embed" if model.cfg.tie_embeddings else "unembed"
    vocab = specs[table]["table"][0]
    lay = MeshLayout(mesh)

    @torch.no_grad()
    def mesh_serve_step(params, cache, tokens, pos):
        c_specs = cache_shardings(cache, mesh, rules)
        local = _cache_pieces(cache, c_specs, mesh)
        b = fit_spec(mesh, (rules["batch"],), (tokens.shape[0],))[0]
        if axes_index(mesh, b)[1] != axes_index(mesh, _batch_axes(c_specs))[1]:
            raise ValueError(
                f"build_decode_step: the tokens' rows split over {b!r}, the "
                f"cache's over {_batch_axes(c_specs)!r}")
        pos = pos_tensor(pos, tokens.device)
        with axis_rules(mesh, dict(rules, cache_seq=_seq_axes(c_specs))):
            _, tree = mesh_weights(params, specs, grad=False)
            logits = decode_step_(tree, local, _rows(tokens, mesh, b),
                                  _rows(pos, mesh, b) if pos.ndim else pos,
                                  model.cfg)
        shape = (tokens.shape[0], model.cfg.vocab_padded)
        out = fit_spec(mesh, tuple(logical_spec(("batch", "vocab"), dict(
            rules, vocab=vocab))), shape)
        return wrap(logits[:, -1, :].contiguous(), shape,
                    placements(mesh, out), lay), cache

    return mesh_serve_step
