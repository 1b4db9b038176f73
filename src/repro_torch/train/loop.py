"""Training runner (port of ``repro.train.loop``): the production loop with
every fault-tolerance feature wired in (checkpoint/restart, straggler
watchdog, deterministic data, projection constraints, microbatch gradient
accumulation).

``train`` runs on the card unless given ``device=`` (the tests pass
"cpu"). On the card every full-sequence attention of the step goes through
the flash-attention kernels, forward and backward, and the projection
through the engine's solver (``proj_solver="kernel"``: the l1,inf
kernels), and every SSD scan of an ``ssm`` or ``hybrid`` block through
the SSD kernels, forward and backward (``SSDFunction``). On the CPU the
same step runs the kernels' plain versions.

The step owns its state as the reference's jitted step owns its donated
buffers: the backward accumulates into one f32 gradient tree in place, and
the Adam update writes the params and moments in place (``inplace`` of
``ProjectionEngine.projected_update``), so a full-size step holds params,
gradients and moments once each (and a projected leaf twice, briefly).
With ``mesh`` (a (data, model) ``DeviceMesh``, ``launch.mesh``) and
``rules`` (``dist.sharding``; ``default_rules()`` when None) the step is
the sharded one of ``launch.steps``: params and moments are ``DTensor``s
under ``launch.steps.param_shardings``, each rank computes on its rows of
the batch with each layer's weights gathered over data on entry to it and
its heads / experts / hidden units / vocab split over model
(``mesh_loss_and_grads``), and the update
is the engine's ``fused_sharded`` (``"fused"``) or ``sharded`` solve on
the pieces. Checkpoints hold the full leaves in the reference's format:
rank 0 writes them, every rank reads them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from .._device import resolve_device
from .._tree import tree_map
from ..checkpoint import AsyncCheckpointer, latest_step, restore_tree
from ..core import ProjectionEngine, sparsity_report
from ..data.pipeline import LMBatcher
from ..dist.watchdog import StepWatchdog
from ..models.zoo import Model
from ..optim import AdamConfig, adam_init
from ..optim.adam import AdamState
from .._tree import leaves

__all__ = ["TrainConfig", "build_accum_step", "lr_at", "train"]


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    log_every: int = 10
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    keep_ckpts: int = 3
    microbatches: int = 1          # gradient accumulation
    lr: float = 3e-4
    warmup: int = 20
    with_projection: bool = True
    proj_solver: str = "fused"     # engine solver; "fused" = two-pass step
                                   # where the family supports it, Newton
                                   # elsewhere ("kernel": the l1,inf kernels)
    seed: int = 0


def _grad_leaf(p: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """A leaf sharing ``p``'s storage whose gradient accumulates into ``g``
    in place (autograd adds into a ``.grad`` that is already set)."""
    leaf = p.detach().requires_grad_()
    leaf.grad = g
    return leaf


def _grad_tree(params: Dict[str, Any], grads: Dict[str, Any]):
    """The tree the backward differentiates. Each stacked block leaf (the
    decoder's and an encoder's) is handed over as one leaf a layer (``models.transformer._layer`` takes
    either): indexing a stacked leaf under autograd would build a
    full-size zero gradient for every layer."""
    return {k: tree_map(
        (lambda p, g: [_grad_leaf(p[i], g[i]) for i in range(p.shape[0])])
        if k in ("blocks", "enc_blocks") else _grad_leaf, v, grads[k])
        for k, v in params.items()}


# ---------------------------------------------------------------------------
# the sharded step's gradient
# ---------------------------------------------------------------------------

def _data_dim(spec) -> Optional[int]:
    """The dim a param's spec splits over "data" (FSDP), or None."""
    for d, axes in enumerate(spec):
        if axes == "data":
            return d
        if isinstance(axes, tuple) and "data" in axes:
            raise ValueError(f"spec {spec}: a param dim split over data and "
                             f"other axes is not supported")
    return None


def mesh_weights(params, specs, grad: bool):
    """(pieces, tree): this rank's param pieces (leaves whose ``.grad``
    takes the piece's gradient when ``grad``) and the tree the model
    computes with: the same pieces, each recorded with the dim it splits
    over data (``dist.sharding.fsdp_piece``), so that each layer gathers
    its own weights over data on entry (``dist.sharding.gathered``; its
    backward reduces their gradients over data) and only one layer's are
    whole at a time; a stacked block leaf is handed over as one piece a
    layer (``unbind``: its backward stacks the layers' gradients once)."""
    from .._tree import flatten_with_path, unflatten_like
    from ..dist.layout import local_of
    from ..dist.sharding import fsdp_piece
    spec_of = dict(flatten_with_path(specs))
    pieces, out = [], []
    for path, x in flatten_with_path(params):
        leaf = local_of(x).detach()
        if grad:
            leaf.requires_grad_()
        dim = _data_dim(spec_of[path])
        if path.split("/")[0] in ("blocks", "enc_blocks"):
            w = [fsdp_piece(t, None if dim is None else dim - 1)
                 for t in leaf.unbind(0)]
        else:
            w = fsdp_piece(leaf.view_as(leaf), dim)
        pieces.append(leaf)
        out.append(w)
    return pieces, unflatten_like(params, out)


def local_batch(batch: Dict[str, torch.Tensor]):
    """This rank's rows of the global batch (every rank holds all of it):
    each leaf recorded as replicated and ``shard``ed to ("batch", ...), a
    local slice."""
    from ..dist.sharding import Spec, placed, shard
    return {k: shard(placed(v, Spec(*(None,) * v.ndim)), "batch",
                     *(None,) * (v.ndim - 1)) for k, v in batch.items()}


def _as_dtensor(piece: Optional[torch.Tensor], x):
    """``piece`` (this rank's gradient of ``x``'s piece, zeros when None)
    as a ``DTensor`` laid out as ``x``."""
    from ..dist.layout import MeshLayout, wrap
    if piece is None:
        piece = torch.zeros_like(x.to_local())
    return wrap(piece, x.shape, tuple(x.placements),
                MeshLayout(x.device_mesh))


def mesh_loss_and_grads(model: Model, params, specs, batch, mesh,
                        microbatches: int = 1):
    """The sharded step's loss and gradients, inside an active
    ``axis_rules(mesh, rules)``: (loss, metrics, grads). ``params``:
    ``DTensor``s under ``specs``; ``batch``: the global batch. The loss and
    metrics are the global ones on every rank (this rank's parts summed
    over data, ``dp_loss``; the MoE auxiliaries averaged over data); the
    gradients ``DTensor``s laid out as ``params``, summed over
    ``microbatches`` consecutive row blocks of each rank's rows, in order,
    and divided by their number."""
    from .._tree import leaves, unflatten_like
    from ..dist.sharding import axis_size, data_sum
    rows = local_batch(batch)
    n = microbatches
    per = next(iter(rows.values())).shape[0] // n
    loss, metrics = None, None
    pieces = None
    for j in range(n):
        mb = {k: v[j * per:(j + 1) * per] for k, v in rows.items()}
        pieces_j, tree = mesh_weights(params, specs, grad=True)
        if pieces is not None:       # accumulate into the first pieces
            for a, b in zip(pieces_j, pieces):
                a.grad = b.grad
        pieces = pieces_j
        l, met = model.loss(tree, mb)
        l.backward()
        del tree
        loss = l.detach() if loss is None else loss + l.detach()
        met = {k: v.detach() for k, v in met.items()}
        metrics = met if metrics is None else {
            k: metrics[k] + met[k] for k in met}
    dp = axis_size(mesh, "data")
    grads = [p.grad if p.grad is None or n == 1 else p.grad / n
             for p in pieces]
    grads = unflatten_like(params, [_as_dtensor(g, x) for g, x in
                                    zip(grads, leaves(params))])
    loss = data_sum(loss / n, "dp_loss")
    metrics = {k: data_sum(v / n, "dp_loss") / (1 if k == "ce" else dp)
               for k, v in metrics.items()}
    return loss, metrics, grads


def to_specs(tree, specs, mesh):
    """``DTensor`` leaves brought back to their ``specs``' layouts: the
    sharded projection returns a leaf that was replicated on a mesh dim
    column-sharded there (the reference's ``out_specs``); each such leaf
    moves back by one ``dist.layout.move`` (an all-to-all, counted
    ``relayout_move``), never an all-gather."""
    from .._tree import flatten_with_path, unflatten_like
    from ..dist.layout import MeshLayout, move, wrap
    from ..dist.sharding import _COUNTS, placements
    lay = MeshLayout(mesh)
    spec_of = dict(flatten_with_path(specs))
    out = []
    for path, x in flatten_with_path(tree):
        want = placements(mesh, spec_of[path])
        have = tuple(x.placements)
        if have != want:
            _COUNTS["relayout_move"] += 1
            x = wrap(move(x.to_local(), x.shape, have, want, lay), x.shape,
                     want, lay)
        out.append(x)
    return unflatten_like(tree, out)


def to_specs_state(params, opt_state, specs, mesh):
    """``to_specs`` of the params and both Adam moments."""
    return to_specs(params, specs, mesh), AdamState(
        count=opt_state.count, mu=to_specs(opt_state.mu, specs, mesh),
        nu=to_specs(opt_state.nu, specs, mesh))


def build_accum_step(model: Model, acfg: AdamConfig, tcfg: TrainConfig,
                     mesh=None, rules=None, engine: ProjectionEngine = None):
    """The train step ``step(params, opt_state, proj_state, batch, lr,
    count=None) -> (params, opt_state, proj_state, loss)``: the gradients
    of ``tcfg.microbatches`` microbatches (consecutive row blocks of the
    batch) summed in microbatch order in f32 and divided by their number,
    then the shared ``ProjectionEngine.projected_update`` step core (Adam +
    packed warm-started projection + every_k gate). ``count`` is the new
    optimizer count on the host, when the caller tracks it (``train``
    does): the every_k gates then skip the solves off their step. The
    step's Adam update writes into the tensors of ``params`` and
    ``opt_state``, so the caller uses the returned trees only; params are
    f32.

    With ``mesh``: params and moments are ``DTensor``s under
    ``launch.steps.param_shardings(model, mesh, rules)``, ``batch`` the
    global one; the gradients come from ``mesh_loss_and_grads`` and the
    update from ``engine`` (``mesh_engine`` when None); every leaf comes
    back as a new ``DTensor``.
    """
    cfg = model.cfg
    n = tcfg.microbatches
    if mesh is not None:
        return _mesh_accum_step(model, acfg, tcfg, mesh, rules, engine)
    if engine is None:
        engine = ProjectionEngine(
            cfg.projection_specs if tcfg.with_projection else (),
            solver=tcfg.proj_solver)

    def step(params, opt_state, proj_state, batch, lr, count=None):
        grads = tree_map(torch.zeros_like, params)
        leaves = _grad_tree(params, grads)
        rows = next(iter(batch.values())).shape[0] // n
        loss = None
        for j in range(n):
            mb = {key: x[j * rows:(j + 1) * rows] for key, x in batch.items()}
            l, _ = model.loss(leaves, mb)
            l.backward()
            loss = l.detach() if loss is None else loss + l.detach()
        del leaves
        if n > 1:
            tree_map(lambda g: g.div_(n), grads)
            loss = loss / n
        with torch.no_grad():
            params, opt_state, proj_state = engine.projected_update(
                grads, opt_state, params, acfg, lr=lr, state=proj_state,
                count=count, inplace=True)
        return params, opt_state, proj_state, loss

    return step


def mesh_engine(model: Model, tcfg: TrainConfig, mesh) -> ProjectionEngine:
    """The engine of a sharded train loop: ``tcfg.proj_solver`` on the
    mesh, "fused" as ``fused_sharded`` and any other solver as the
    mesh-resident Newton, ``sharded``."""
    return ProjectionEngine(
        model.cfg.projection_specs if tcfg.with_projection else (),
        solver="fused_sharded" if tcfg.proj_solver == "fused"
        else "sharded", mesh=mesh)


def _mesh_accum_step(model, acfg, tcfg, mesh, rules, engine):
    from ..dist.sharding import axis_rules, default_rules
    from ..launch.steps import param_shardings
    rules = rules or default_rules()
    specs = param_shardings(model, mesh, rules)
    if engine is None:
        engine = mesh_engine(model, tcfg, mesh)

    def step(params, opt_state, proj_state, batch, lr, count=None):
        with axis_rules(mesh, rules):
            loss, _, grads = mesh_loss_and_grads(
                model, params, specs, batch, mesh, tcfg.microbatches)
            with torch.no_grad():
                params, opt_state, proj_state = engine.projected_update(
                    grads, opt_state, params, acfg, lr=lr, state=proj_state,
                    count=count)
                params, opt_state = to_specs_state(params, opt_state, specs,
                                                   mesh)
        return params, opt_state, proj_state, loss

    return step


def lr_at(tcfg: TrainConfig, step: int) -> float:
    warm = min(1.0, (step + 1) / max(tcfg.warmup, 1))
    return tcfg.lr * warm


def train(model: Model, batcher: LMBatcher, tcfg: TrainConfig,
          mesh=None, rules=None, resume: bool = True,
          on_step: Optional[Callable[[int, float, float], None]] = None,
          device=None) -> Dict[str, Any]:
    """Run the loop on ``device`` (the card when None; raises when CUDA is
    missing); auto-resumes from the latest checkpoint in ``tcfg.ckpt_dir``
    if present. Params start from ``model.init`` with a
    ``torch.Generator(device)`` seeded by ``tcfg.seed``; batches go to the
    device as int64.

    >>> out = train(build(cfg), LMBatcher(SyntheticLM(cfg.vocab), 2, 16),
    ...             TrainConfig(steps=4), device="cpu")

    With ``mesh``: every rank calls it with the same arguments and its
    ``device`` the mesh's (the tests' "cpu", or the card); params start
    from the same draw on every rank, each keeping its pieces; the
    returned params, moments and losses are the mesh's (``DTensor``s).
    """
    dev = resolve_device(device)
    acfg = AdamConfig(lr=tcfg.lr)
    params = model.init(torch.Generator(device=dev).manual_seed(tcfg.seed),
                        device=dev)
    opt_state = adam_init(params, acfg)
    start_step = 0

    if mesh is not None:
        engine = mesh_engine(model, tcfg, mesh)
    else:
        engine = ProjectionEngine(
            model.cfg.projection_specs if tcfg.with_projection else (),
            solver=tcfg.proj_solver)
    proj_state = engine.init_state(params)

    ckpt = None
    if tcfg.ckpt_dir:
        if mesh is None or torch.distributed.get_rank() == 0:
            ckpt = AsyncCheckpointer(tcfg.ckpt_dir, keep=tcfg.keep_ckpts)
        if resume and latest_step(tcfg.ckpt_dir) is not None:
            # the projection theta state rides in the checkpoint so a resume
            # stays warm-started; pre-engine checkpoints lack it — fall back
            # to a cold Newton start rather than refusing the restore
            try:
                state = {"params": params, "opt": opt_state,
                         "proj": proj_state}
                state, start_step = restore_tree(state, tcfg.ckpt_dir)
                proj_state = state["proj"]
            except KeyError:
                state = {"params": params, "opt": opt_state}
                state, start_step = restore_tree(state, tcfg.ckpt_dir)
                print("[train] checkpoint has no projection state; "
                      "cold-starting Newton")
            params, opt_state = state["params"], state["opt"]
            del state
            print(f"[train] resumed from step {start_step}")

    if mesh is not None:
        params, opt_state = _to_mesh(model, mesh, rules, params, opt_state)
    save = _saver(ckpt, mesh)
    step_fn = build_accum_step(model, acfg, tcfg, mesh, rules, engine=engine)
    watchdog = StepWatchdog(on_straggler=lambda s, dt, ew: print(
        f"[watchdog] straggler step {s}: {dt:.3f}s vs EWMA {ew:.3f}s"))

    count = int(opt_state.count)        # tracked on the host from here
    losses = []
    step_metrics = []   # per-step watchdog snapshots (dist/watchdog.py)
    for step in range(start_step, tcfg.steps):
        batch = {k: torch.from_numpy(np.asarray(v)).to(dev, torch.int64)
                 for k, v in batcher.get(step).items()}
        watchdog.start()
        count += 1
        params, opt_state, proj_state, loss = step_fn(
            params, opt_state, proj_state, batch, lr_at(tcfg, step),
            count=count)
        loss_f = float(loss)            # waits for the step
        dt = watchdog.stop(step)
        step_metrics.append(watchdog.metrics())
        losses.append(loss_f)
        if on_step:
            on_step(step, loss_f, dt)
        if step % tcfg.log_every == 0:
            print(f"[train] step {step:5d} loss {loss_f:.4f} "
                  f"({dt*1e3:.0f} ms)", flush=True)
        if tcfg.ckpt_dir and (step + 1) % tcfg.ckpt_every == 0:
            save(params, opt_state, proj_state, step + 1)
    if tcfg.ckpt_dir:
        save(params, opt_state, proj_state, tcfg.steps)
        if ckpt:
            ckpt.wait()

    report = {}
    if model.cfg.projection_specs:
        whole = params
        if mesh is not None:
            from ..convert import params_from_mesh
            whole = params_from_mesh(params, mesh)
        report = sparsity_report(whole, model.cfg.projection_specs)
    return {"params": params, "opt_state": opt_state, "losses": losses,
            "proj_state": proj_state, "sparsity": report,
            "straggler_events": watchdog.events,
            "step_metrics": step_metrics,
            "watchdog": watchdog.metrics()}


def _to_mesh(model, mesh, rules, params, opt_state):
    """Full params and moments (the same on every rank) -> their pieces
    under ``param_shardings``."""
    from ..convert import params_to_mesh
    from ..dist.sharding import default_rules
    from ..launch.steps import param_shardings
    specs = param_shardings(model, mesh, rules or default_rules())
    dev = leaves(params)[0].device
    put = lambda tree: params_to_mesh(tree, mesh, specs, dev)
    return put(params), AdamState(count=opt_state.count,
                                  mu=put(opt_state.mu), nu=put(opt_state.nu))


def _saver(ckpt, mesh):
    """save(params, opt, proj, step): the reference's checkpoint of the
    full leaves; on a mesh every rank brings the leaves whole (they all
    take part in the moves) and rank 0 writes them."""
    def save(params, opt_state, proj_state, step):
        if mesh is not None:
            from ..convert import params_from_mesh
            params = params_from_mesh(params, mesh)
            opt_state = AdamState(count=opt_state.count,
                                  mu=params_from_mesh(opt_state.mu, mesh),
                                  nu=params_from_mesh(opt_state.nu, mesh))
        if ckpt is not None:
            ckpt.save({"params": params, "opt": opt_state,
                       "proj": proj_state}, step)

    return save
