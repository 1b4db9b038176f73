"""Spawned gloo rank groups for the port's distributed tests (CPU).

``run_ranks(case, world, mesh_shape, workdir)`` starts ``world`` processes
(``spawn``), each joining a gloo group through a file under ``workdir``
(never a fixed port: test files run side by side), builds
``make_local_mesh(*mesh_shape, device=...)`` (the CPU unless the card is
asked for: its ranks then share it), runs the function ``case``
of this module and pickles what it returns; the parent gets the list, rank
by rank. This module imports torch and repro_torch only, so the ranks
start without JAX.

The case functions build every input from numpy seeds on every rank, lay
it out as DTensors (``place``), and return numpy pieces with their boxes
(``piece``), so the parent can hold the assembled result against the
port's single-device solve and against JAX.
"""
import contextlib
import itertools
import os
import pickle
import time

import numpy as np
import torch
import torch.distributed as dist


def run_ranks(case, world, mesh_shape, workdir, timeout=300,
              device="cpu", **kw):
    """Run ``case`` on ``world`` spawned ranks; returns their results."""
    import torch.multiprocessing as mp
    workdir = str(workdir)
    ctx = mp.start_processes(_entry, args=(case, world, tuple(mesh_shape),
                                           workdir, device, kw),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{case} on {world} ranks: {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join(10)
    out = []
    for r in range(world):
        with open(os.path.join(workdir, f"{case}.rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def _entry(rank, case, world, mesh_shape, workdir, device, kw):
    from repro_torch.launch.mesh import make_local_mesh
    torch.set_num_threads(1)
    if device == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(workdir, f"{case}.rdv"),
        rank=rank, world_size=world)
    try:
        mesh = make_local_mesh(*mesh_shape, device=device)
        out = globals()[case](mesh, **kw)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(workdir, f"{case}.rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


# -- layouts -----------------------------------------------------------------

def place(full, placements, mesh):
    """A DTensor over ``mesh`` holding the numpy array ``full`` laid out as
    ``placements`` (a tuple of ("S", dim) / ("R",) per mesh dim), or the
    plain tensor when ``placements`` is None (every rank holds it)."""
    from torch.distributed.tensor import distribute_tensor
    t = torch.from_numpy(np.ascontiguousarray(full)).to(mesh.device_type)
    if placements is None:
        return t.clone()
    # every rank holds ``full``: each keeps its own chunk, no collective
    return distribute_tensor(t, mesh, to_placements(placements),
                             src_data_rank=None)


def to_placements(spec):
    from torch.distributed.tensor import Replicate, Shard
    return tuple(Shard(p[1]) if p[0] == "S" else Replicate() for p in spec)


def piece(x, mesh):
    """(box, numpy piece, placement names) of this rank's part of ``x``."""
    from repro_torch.dist.layout import (MeshLayout, _box, local_of,
                                         placements_of)
    lay = MeshLayout(mesh)
    pl = placements_of(x, lay)
    box = _box(tuple(x.shape), pl, lay.shape, lay.coords[lay.me])
    return (box, local_of(x).detach().float().cpu().numpy(),
            tuple(type(p).__name__ for p in pl))


def assemble(pieces, shape):
    """The full array from every rank's ``piece`` (replicated pieces
    overlap with equal values)."""
    out = np.full(shape, np.nan, np.float32)
    for box, arr, _ in pieces:
        out[tuple(slice(lo, hi) for lo, hi in box)] = arr
    assert not np.isnan(out).any(), "pieces do not cover the tensor"
    return out


class CollectiveLog:
    """What ``recorded_collectives`` saw: ``reduces``, the (shape, op) of
    every all_reduce in call order; ``seconds``, the wall time spent in
    all_reduce, all_to_all_single and all_gather."""

    def __init__(self):
        self.reduces, self.seconds = [], 0.0


_TIMED = ("all_reduce", "all_to_all_single", "all_gather")


@contextlib.contextmanager
def recorded_collectives(sync=None):
    """Record the ``torch.distributed`` collectives called meanwhile into
    a ``CollectiveLog``. ``sync`` (e.g. ``torch.cuda.synchronize``) runs
    before and after each call, so its time is the collective's alone,
    host staging included."""
    log, real = CollectiveLog(), {n: getattr(dist, n) for n in _TIMED}

    def wrap(name):
        def call(*a, **kw):
            if name == "all_reduce":
                op = kw.get("op", a[1] if len(a) > 1 else dist.ReduceOp.SUM)
                log.reduces.append((tuple(a[0].shape), "MAX" if op ==
                                    dist.ReduceOp.MAX else "SUM"))
            if sync is not None:
                sync()
            t = time.perf_counter()
            out = real[name](*a, **kw)
            if sync is not None:
                sync()
            log.seconds += time.perf_counter() - t
            return out
        return call

    for n in _TIMED:
        setattr(dist, n, wrap(n))
    try:
        yield log
    finally:
        for n, fn in real.items():
            setattr(dist, n, fn)


class _count_calls:
    """Count the calls of ``torch.distributed.<name>`` inside the block
    (``.n``)."""

    def __init__(self, name):
        self.name, self.n = name, 0

    def __enter__(self):
        self.real = getattr(dist, self.name)

        def call(*a, **kw):
            self.n += 1
            return self.real(*a, **kw)
        setattr(dist, self.name, call)
        return self

    def __exit__(self, *exc):
        setattr(dist, self.name, self.real)


def newton_calls(plans, iters, max_iter=32):
    """The all-reduces of one solve of each plan, in plan order: a (3, G)
    SUM, a (2, G) SUM per Eq.-(19) evaluation and a (G,) MAX. ``plans``:
    (key, G) pairs; ``iters``: {key: evaluation count}. A solve stopped at
    ``max_iter`` re-evaluates once when its theta still moves, one more
    SUM, so such a plan has two candidates. Returns every candidate."""
    per_plan = []
    for key, G in plans:
        n = iters[key]
        per_plan.append([[((3, G), "SUM")] + [((2, G), "SUM")] * k
                         + [((G,), "MAX")]
                         for k in ((n,) if n < max_iter else (n, n + 1))])
    return [sum(c, []) for c in itertools.product(*per_plan)]


def comm_counts(cdm):
    """{"all_reduce": n, "all_to_all": n, "all_gather": n} of a
    ``CommDebugMode``."""
    out = {"all_reduce": 0, "all_to_all": 0, "all_gather": 0}
    for op, n in cdm.get_comm_counts().items():
        name = str(op)
        for key, words in (("all_reduce", ("allreduce", "all_reduce")),
                           ("all_to_all", ("alltoall", "all_to_all")),
                           ("all_gather", ("allgather", "all_gather"))):
            if any(w in name for w in words):
                out[key] += n
    return out


def _tree_pieces(tree, mesh):
    from repro_torch._tree import flatten_with_path
    return {k: piece(v, mesh) for k, v in flatten_with_path(tree)}


def _np_state(state):
    return {k: v.cpu().numpy() for k, v in state.items()}


# -- the cases -----------------------------------------------------------------

def projection_np(seed=0):
    """Leaves of the sharded-projection cases: a stacked FSDP leaf, a
    row-sharded and a column-sharded matrix, a replicated one, one whose
    27 columns no mesh here divides, a leaf projected over its trailing
    dim, and a column-sharded Hoyer leaf."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    return {"blocks": {"w1": f(4, 16, 64)}, "enc": {"w": f(32, 128)},
            "dec": {"w": f(16, 64)}, "rep": {"w": f(24, 32)},
            "odd": {"w": f(16, 27)}, "tr": {"w": f(48, 20)},
            "hoy": {"w": f(16, 64)}}


def projection_specs(mod):
    """Every packable family of the registry, plus per-leaf Hoyer."""
    S = mod.ProjectionSpec
    return (S(pattern=r"blocks/w1", norm="bilevel", radius=16.0),
            S(pattern=r"enc/w", norm="l1inf", radius=8.0),
            S(pattern=r"dec/w", norm="l1inf_weighted", radius=8.0,
              weights=tuple(1.0 + 0.01 * i for i in range(64))),
            S(pattern=r"rep/w", norm="l12", radius=3.0),
            S(pattern=r"odd/w", norm="l1inf_masked", radius=6.0),
            S(pattern=r"tr/w", norm="l1inf", radius=5.0, axis=1),
            S(pattern=r"hoy/w", norm="hoyer", radius=0.75))


# placements per leaf on the (2, 1) and (2, 2) meshes
PLACEMENTS = {
    (2, 1): {"blocks/w1": (("S", 1), ("R",)), "enc/w": (("S", 0), ("R",)),
             "dec/w": (("S", 1), ("R",)), "rep/w": None, "odd/w": None,
             "tr/w": (("S", 1), ("R",)), "hoy/w": (("S", 1), ("R",))},
    (2, 2): {"blocks/w1": (("S", 1), ("S", 1)),
             "enc/w": (("S", 0), ("S", 1)),
             "dec/w": (("S", 1), ("S", 1)), "rep/w": None, "odd/w": None,
             "tr/w": (("S", 1), ("R",)), "hoy/w": (("S", 1), ("S", 1))},
}


def _placed_tree(np_tree, mesh, placements):
    from repro_torch._tree import flatten_with_path, unflatten_like
    flat = flatten_with_path(np_tree)
    return unflatten_like(np_tree, [place(v, placements.get(k), mesh)
                                    for k, v in flat])


def sharded_projection(mesh):
    """The sharded engine's ``apply`` over every family, cold and then
    warm-started from its own theta: pieces, theta, iterations, the
    all-reduce calls of the cold solve, and its collectives by kind."""
    import warnings
    from torch.distributed.tensor.debug import CommDebugMode
    import repro_torch.core as TC
    shape = tuple(mesh.mesh.shape)
    params = _placed_tree(projection_np(), mesh, PLACEMENTS[shape])
    eng = TC.ProjectionEngine(projection_specs(TC), solver="sharded",
                              mesh=mesh)
    state0 = eng.init_state(params)
    with warnings.catch_warnings(record=True) as warned:
        warnings.simplefilter("always")
        with recorded_collectives() as log, CommDebugMode() as cdm:
            out, st, stats = eng.apply(params, state=state0, with_stats=True)
    out2, st2, stats2 = eng.apply(params, state=st, with_stats=True)
    plans, _ = eng.plans(params)
    return {"pieces": _tree_pieces(out, mesh), "theta": _np_state(st),
            "iters": dict(stats), "theta_warm": _np_state(st2),
            "iters_warm": dict(stats2), "allreduces": log.reduces,
            "comm": comm_counts(cdm),
            "plans": [(p.key, p.num_segments) for p in plans],
            "warnings": [str(w.message) for w in warned]}


def fused_np(seed=0):
    """The fused-step cases' params and gradients (the reference's
    enc1 + stacked blocks, ``tests/test_multidevice.py`` fused_sharded)."""
    rng = np.random.default_rng(seed)
    params = {"enc1": {"w": rng.normal(size=(64, 256)).astype(np.float32)},
              "blocks": {"w": rng.normal(size=(3, 64, 256)).astype(
                  np.float32)},
              "bias": {"b": rng.normal(size=(256,)).astype(np.float32)}}
    grads = {k: {kk: (0.01 * rng.normal(size=vv.shape)).astype(np.float32)
                 for kk, vv in v.items()} for k, v in params.items()}
    return params, grads


FUSED_PLACEMENTS = {
    (2, 1): {"enc1/w": (("S", 0), ("R",)), "blocks/w": (("S", 2), ("R",)),
             "bias/b": None},
    (2, 2): {"enc1/w": (("S", 0), ("S", 1)),
             "blocks/w": (("S", 2), ("S", 1)), "bias/b": None},
}


def fused_specs(mod, norm, params):
    norm0 = float(np.abs(params["enc1"]["w"]).max(axis=0).sum())
    S = mod.ProjectionSpec
    return (S(pattern=r"enc1/w", norm=norm, radius=0.1 * norm0),
            S(pattern=r"blocks/w", norm=norm, radius=0.05 * norm0, axis=1))


def _opt_placed(opt, mesh, placements):
    from repro_torch.optim.adam import AdamState
    to_np = lambda t: {k: {kk: vv.cpu().numpy() for kk, vv in v.items()}
                       for k, v in t.items()}
    return AdamState(count=opt.count.clone(),
                     mu=_placed_tree(to_np(opt.mu), mesh, placements),
                     nu=_placed_tree(to_np(opt.nu), mesh, placements))


def _max_diff(tree_s, tree_r, mesh):
    """max |sharded - single-device| over the leaves, on this rank's
    pieces, and whether every piece is bit-equal."""
    from repro_torch._tree import flatten_with_path
    worst, same = 0.0, True
    ref = dict(flatten_with_path(tree_r))
    for k, v in flatten_with_path(tree_s):
        box, arr, _ = piece(v, mesh)
        want = ref[k].detach().cpu().numpy()[tuple(slice(lo, hi)
                                                   for lo, hi in box)]
        worst = max(worst, float(np.abs(arr - want).max()))
        same = same and np.array_equal(arr.view(np.int32),
                                       want.astype(np.float32).view(
                                           np.int32))
    return worst, same


def fused_sharded(mesh, clip_norm=None):
    """``fused_sharded`` against ``fused`` (bilevel and l12), two steps with
    the theta warm start crossing between the two solvers; the plain-l1,inf
    fallback against ``sharded``; ``projection_engine_for``'s choice; the
    ``grad_reduce`` composition with ``compressed_psum``."""
    from torch.distributed.tensor.debug import CommDebugMode
    import repro_torch.core as TC
    from repro_torch.configs import get_reduced
    from repro_torch.dist.compression import compressed_psum
    from repro_torch.kernels.fused_step import kernel as FK
    from repro_torch.launch.steps import projection_engine_for
    from repro_torch.optim import AdamConfig, adam_init
    shape = tuple(mesh.mesh.shape)
    pl = FUSED_PLACEMENTS[shape]
    P, Gr = fused_np()
    params_r, grads_r = (_placed_tree(t, mesh, {}) for t in (P, Gr))
    params_s, grads_s = (_placed_tree(t, mesh, pl) for t in (P, Gr))
    acfg = AdamConfig(lr=1e-3, clip_norm=clip_norm)
    out = {}
    for norm in ("bilevel", "l12"):
        specs = fused_specs(TC, norm, P)
        ref = TC.ProjectionEngine(specs, solver="fused")
        shd = TC.ProjectionEngine(specs, solver="fused_sharded", mesh=mesh)
        opt_r = adam_init(params_r, acfg)
        opt_s = _opt_placed(opt_r, mesh, pl)
        state0 = ref.init_state(params_r)
        TC.engine_counters_reset()
        FK.reset_launch_counts()
        with recorded_collectives() as log, CommDebugMode() as cdm:
            p_s, o_s, s_s, it_s = shd.projected_update(
                grads_s, opt_s, params_s, acfg, state=state0,
                with_stats=True)
        counters, launches = TC.engine_counters(), FK.launch_counts()
        p_r, o_r, s_r, it_r = ref.projected_update(
            grads_r, opt_r, params_r, acfg, state=state0, with_stats=True)
        # step 2 warm-started across the switch: the single-device
        # solver's state into the sharded engine
        p_x, o_x, s_x, it_x = shd.projected_update(
            grads_s, _opt_placed(o_r, mesh, pl),
            _placed_tree({k: {kk: vv.cpu().numpy() for kk, vv in v.items()}
                          for k, v in p_r.items()}, mesh, pl),
            acfg, state=s_r, with_stats=True)
        p_r2, o_r2, s_r2, it_r2 = ref.projected_update(
            grads_r, o_r, p_r, acfg, state=s_r, with_stats=True)
        out[norm] = {
            "params": _max_diff(p_s, p_r, mesh),
            "mu": _max_diff(o_s.mu, o_r.mu, mesh),
            "nu": _max_diff(o_s.nu, o_r.nu, mesh),
            "theta": (_np_state(s_s), _np_state(s_r)),
            "iters": (dict(it_s), dict(it_r)),
            "step2_params": _max_diff(p_x, p_r2, mesh),
            "step2_theta": (_np_state(s_x), _np_state(s_r2)),
            "step2_iters": (dict(it_x), dict(it_r2)),
            "pieces": _tree_pieces(p_s, mesh),
            "allreduces": log.reduces, "comm": comm_counts(cdm),
            "counters": counters, "launches": launches,
            "num_segments": [p.num_segments for p in ref.plans(P)[0]]}

    # plain l1,inf has no streaming hook: fused_sharded solves it exactly
    # as sharded
    specs = fused_specs(TC, "l1inf", P)
    runs = {}
    for solver in ("fused_sharded", "sharded"):
        eng = TC.ProjectionEngine(specs, solver=solver, mesh=mesh)
        opt = _opt_placed(adam_init(params_r, acfg), mesh, pl)
        runs[solver] = eng.projected_update(grads_s, opt, params_s, acfg,
                                            state=eng.init_state(params_r))
    same = True
    for a, b in zip(_leaves_of(runs["fused_sharded"]),
                    _leaves_of(runs["sharded"])):
        a = a.to_local() if hasattr(a, "to_local") else a
        b = b.to_local() if hasattr(b, "to_local") else b
        same = same and torch.equal(a, b)
    out["fallback_bit_equal"] = bool(same)
    cfg = get_reduced("gemma_7b")
    out["engine_for"] = (projection_engine_for(cfg, mesh).solver,
                         projection_engine_for(cfg, mesh).mesh is mesh,
                         projection_engine_for(cfg, None).solver)

    # grad_reduce: per-rank partial gradients summed by compressed_psum
    # inside the fused_sharded step, against the step on the summed
    # gradient
    specs = fused_specs(TC, "bilevel", P)
    shd = TC.ProjectionEngine(specs, solver="fused_sharded", mesh=mesh)
    lay_rank = dist.get_rank()
    rng = np.random.default_rng(100 + lay_rank)
    partial = {k: {kk: torch.from_numpy(
        (0.01 * rng.normal(size=vv.shape)).astype(np.float32)).to(
            mesh.device_type)
        for kk, vv in v.items()} for k, v in P.items()}
    composed = {}
    for mode in ("none", "int8"):
        opt = _opt_placed(adam_init(params_r, acfg), mesh, pl)
        with recorded_collectives() as log:
            res = shd.projected_update(
                partial, opt, params_s, acfg,
                state=shd.init_state(params_r), with_stats=True,
                grad_reduce=lambda g, mode=mode: compressed_psum(g, mesh,
                                                                 mode))
        composed[mode] = {"pieces": _tree_pieces(res[0], mesh),
                          "theta": _np_state(res[2]),
                          "iters": dict(res[3]), "allreduces": log.reduces}
    summed = compressed_psum(partial, mesh, "none")
    opt = _opt_placed(adam_init(params_r, acfg), mesh, pl)
    direct = shd.projected_update(summed, opt, params_s, acfg,
                                  state=shd.init_state(params_r))
    composed["direct_pieces"] = _tree_pieces(direct[0], mesh)
    composed["summed"] = {k: {kk: vv.cpu().numpy() for kk, vv in v.items()}
                          for k, v in summed.items()}
    out["composed"] = composed
    return out


def _leaves_of(result):
    from repro_torch._tree import leaves
    p, o, s = result
    return leaves(p) + leaves(o.mu) + leaves(o.nu) + [s[k] for k in sorted(s)]


def compression(mesh, n=4096, k_frac=0.05):
    """``compressed_psum`` of two leaves in each mode, every rank with its
    own partial; the partials and the results, with the collectives."""
    from torch.distributed.tensor.debug import CommDebugMode
    from repro_torch.dist.compression import compressed_psum
    rank = dist.get_rank()
    rng = np.random.default_rng(10 + rank)
    tree = {"a": rng.normal(size=(n,)).astype(np.float32),
            "b": (rng.normal(size=(8, 33)) * 1e-3).astype(np.float32)}
    tt = {k: torch.from_numpy(v) for k, v in tree.items()}
    out = {"partial": tree}
    for mode in ("none", "int8", "topk"):
        with CommDebugMode() as cdm:
            res = compressed_psum(tt, mesh, mode=mode, k_frac=k_frac)
        out[mode] = ({k: v.numpy() for k, v in res.items()},
                     comm_counts(cdm))
    return out


def capped_np(seed=5):
    """A (32, 64) buffer in two segments of 32 columns, and their radii:
    from a cold start theta still moves after two evaluations."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(32, 64)).astype(np.float32),
            np.repeat(np.arange(2, dtype=np.int32), 32),
            np.array([4.0, 2.0], np.float32))


def capped_solve(mesh, max_iter=2):
    """``project_l1inf_segmented_sharded`` of this rank's column block of
    ``capped_np``, stopped at ``max_iter`` evaluations: its block, theta,
    iterations and all-reduces."""
    from repro_torch.core.l1inf import project_l1inf_segmented_sharded
    from repro_torch.dist.layout import MeshLayout
    Y, sids, C = capped_np()
    lay = MeshLayout(mesh)
    w = Y.shape[1] // lay.size
    lo, hi = lay.rank * w, (lay.rank + 1) * w
    with recorded_collectives() as log:
        X, th, it = project_l1inf_segmented_sharded(
            torch.from_numpy(Y[:, lo:hi].copy()), torch.from_numpy(sids[lo:hi]),
            torch.from_numpy(C), num_segments=2, group=lay.group,
            max_iter=max_iter)
    return {"cols": (lo, hi), "X": X.numpy(), "theta": th.numpy(),
            "iters": it, "allreduces": log.reduces}


def all_cases(mesh):
    """The projection file's cases in one group."""
    return {"projection": sharded_projection(mesh),
            "capped": capped_solve(mesh),
            "fused": fused_sharded(mesh),
            "fused_clip": fused_sharded(mesh, clip_norm=1.0)}


# -- the sharded production step (launch/steps.py, train/loop.py) -------------

def _step_inputs(arch, seed=0, B=4, S=16, every_k=None, over=None):
    """(port model, numpy params drawn by the port, tokens, labels) of a
    reduced config (with the ``ArchConfig`` changes ``over``; its
    projection specs at ``every_k`` when given); every rank draws the
    same."""
    import dataclasses
    from repro_torch import configs as TC
    from repro_torch._tree import tree_map
    from repro_torch.models import zoo as TZ
    cfg = dataclasses.replace(TC.get_reduced(arch), **(over or {}))
    if every_k is not None:
        cfg = dataclasses.replace(cfg, projection_specs=tuple(
            dataclasses.replace(s, every_k=every_k)
            for s in cfg.projection_specs))
    model = TZ.build(cfg)
    params = model.init(torch.Generator().manual_seed(seed), device="cpu")
    rng = np.random.default_rng(seed + 1)
    tok = rng.integers(0, cfg.vocab, size=(B, S))
    labels = rng.integers(0, cfg.vocab, size=(B, S))
    labels[0, :2] = -1
    return model, tree_map(lambda p: p.numpy(), params), tok, labels


def extra_batch(cfg, tok, seed=0):
    """The batch leaves beside tokens and labels that ``cfg`` reads, as
    numpy f32, every rank's the same: image_embeds (B, n_img_tokens, d)
    for a vision config, frames (B, S, d) for an encoder-decoder."""
    rng = np.random.default_rng(seed + 2)
    B, S = tok.shape
    out = {}
    if cfg.n_img_tokens:
        out["image_embeds"] = rng.normal(
            size=(B, cfg.n_img_tokens, cfg.d_model)).astype(np.float32)
    if cfg.encdec:
        out["frames"] = rng.normal(size=(B, S, cfg.d_model)).astype(
            np.float32)
    return out


def _full_np(tree, mesh):
    """Every leaf of a ``DTensor`` tree whole, as numpy (rank 0 keeps it,
    the others return None: every rank takes part in the moves)."""
    from repro_torch._tree import flatten_with_path
    from repro_torch.convert import params_from_mesh
    whole = params_from_mesh(tree, mesh)
    if dist.get_rank() != 0:
        return None
    return {k: v.detach().float().cpu().numpy()
            for k, v in flatten_with_path(whole)}


def mesh_train_step(mesh, model_cfg, params_np, tok, labels, steps=2,
                    rerun=True):
    """``build_train_step(model, mesh, rules)`` for ``steps`` steps from
    ``params_np`` on the global batch (tok, labels): per step the loss and
    the collectives by kind (``dist.sharding``, the engine's all-reduces
    and all-to-alls), then the params and moments whole; a rerun from the
    same start (bit-equal flag); one prefill and two decode steps over the
    mesh under the train rules (the cache in its pieces), logits whole."""
    from repro_torch._tree import flatten_with_path, leaves, tree_map
    from repro_torch.convert import cache_to_mesh, params_to_mesh
    from repro_torch.dist import sharding as SH
    from repro_torch.launch import steps as ST
    from repro_torch.models import zoo as TZ
    from repro_torch.optim import AdamConfig
    cfg = model_cfg
    model = TZ.build(cfg)
    dev = mesh.device_type
    rules = ST.rules_for_cell(cfg, "train_4k", False)
    specs = ST.param_shardings(model, mesh, rules)
    acfg = AdamConfig(moment_dtype=torch.float32)
    batch = {"tokens": torch.from_numpy(tok).long().to(dev),
             "labels": torch.from_numpy(labels).long().to(dev)}
    extra = {k: torch.from_numpy(v).to(dev)
             for k, v in extra_batch(cfg, tok).items()}
    batch.update(extra)
    step = ST.build_train_step(model, mesh, rules, acfg)

    def run():
        full = tree_map(torch.from_numpy, params_np)
        params = params_to_mesh(full, mesh, specs, dev)
        opt = ST.shard_opt_state(params, acfg)
        eng = ST.projection_engine_for(cfg, mesh)
        proj = eng.init_state(params)
        losses, counts, evals = [], [], []
        for _ in range(steps):
            SH.reset_collective_counts()
            gathers = _count_calls("all_gather")
            with recorded_collectives() as log, gathers:
                loss, met, params, opt, proj = step(params, opt, proj, batch)
            c = SH.collective_counts()
            c["all_reduce_shapes"] = log.reduces
            c["all_gather_calls"] = gathers.n
            counts.append(c)
            losses.append(float(loss))
            evals.append(int(met["proj_newton_extra_evals"]))
        return losses, counts, evals, params, opt, proj

    losses, counts, evals, params, opt, proj = run()
    out = {"losses": losses, "counts": counts, "evals": evals,
           "params": _full_np(params, mesh),
           "mu": _full_np(opt.mu, mesh), "nu": _full_np(opt.nu, mesh),
           "specs": {k: tuple(v) for k, v in flatten_with_path(specs)}}
    if rerun:
        l2, _, _, p2, _, _ = run()
        out["rerun_equal"] = l2 == losses and all(
            torch.equal(a.to_local(), b.to_local())
            for a, b in zip(leaves(params), leaves(p2)))
    full = tree_map(torch.from_numpy, params_np)
    start = params_to_mesh(full, mesh, specs, dev)
    pre = ST.build_prefill_step(model, mesh, rules)
    out["prefill"] = pre(start, dict(extra, tokens=batch["tokens"])).float(
        ).cpu().numpy()
    dec = ST.build_decode_step(model, mesh, rules)
    cache = model.init_cache(tok.shape[0], 8, dtype=torch.float32,
                             device=dev)
    cache = cache_to_mesh(cache, mesh, ST.cache_shardings(cache, mesh, rules),
                          dev)
    lg, cache = dec(start, cache, batch["tokens"][:, :1], 0)
    lg2, _ = dec(start, cache, batch["tokens"][:, 1:2], 1)
    out["decode"] = [_whole_np(lg, mesh), _whole_np(lg2, mesh)]
    return out


def moe_shardmap_loss(mesh, model_cfg, params_np, tok, labels):
    """Model.loss of a MoE config under the mesh (``axis_rules``) with the
    batch's rows split over data: the global loss (this rank's part summed
    over data) and the collectives by kind, for ``moe_impl`` "shardmap"
    and "gspmd" (experts split over model, resp. replicated)."""
    import dataclasses
    from repro_torch._tree import tree_map
    from repro_torch.convert import params_to_mesh
    from repro_torch.dist import sharding as SH
    from repro_torch.launch import steps as ST
    from repro_torch.models import zoo as TZ
    from repro_torch.train.loop import mesh_loss_and_grads
    dev = mesh.device_type
    batch = {"tokens": torch.from_numpy(tok).long().to(dev),
             "labels": torch.from_numpy(labels).long().to(dev)}
    out = {}
    for impl in ("shardmap", "gspmd"):
        cfg = dataclasses.replace(model_cfg, moe_impl=impl)
        model = TZ.build(cfg)
        rules = ST.rules_for_cell(cfg, "train_4k", False)
        specs = ST.param_shardings(model, mesh, rules)
        params = params_to_mesh(tree_map(torch.from_numpy, params_np), mesh,
                                specs, dev)
        SH.reset_collective_counts()
        with SH.axis_rules(mesh, rules):
            loss, met, grads = mesh_loss_and_grads(model, params, specs,
                                                   batch, mesh)
        out[impl] = {"loss": float(loss),
                     "counts": SH.collective_counts(),
                     "w1_spec": tuple(specs["blocks"][
                         next(iter(specs["blocks"]))]["moe"]["w1"]),
                     "grads": _full_np(grads, mesh)}
    return out


def pipeline_run(mesh, n_micro=3, d=16, seed=0, axis="data"):
    """``build_pipeline_fn`` over ``axis`` of ``mesh`` with a tanh-linear
    stage: the output (every rank) and the input and stage weights."""
    from repro_torch.dist.pipeline import build_pipeline_fn
    S = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))[axis]
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=(S, d, d)) / np.sqrt(d)).astype(np.float32)
    x = rng.normal(size=(n_micro, 4, d)).astype(np.float32)
    dev = mesh.device_type
    pipe = build_pipeline_fn(lambda W, h: torch.tanh(h @ W["w"]), S, n_micro,
                             mesh, axis)
    y = pipe({"w": torch.from_numpy(w).to(dev)}, torch.from_numpy(x).to(dev))
    return {"y": y.cpu().numpy(), "w": w, "x": x}


def pipeline_wrong_axis(mesh):
    """The ValueError of a pipeline whose axis size is not n_stages."""
    from repro_torch.dist.pipeline import build_pipeline_fn
    try:
        build_pipeline_fn(lambda W, h: h, 3, 2, mesh, "data")
    except ValueError as e:
        return str(e)
    return None


def mesh_cases(mesh, inputs, train_dir=None, steps=2):
    """``mesh_train_step`` (``steps`` steps) for each (arch, (cfg, params,
    tok, labels)) of ``inputs`` (reruns only for the first), and, with
    ``train_dir``, two steps of ``train(mesh=)`` on reduced stablelm-3b
    checkpointing there: its losses and params whole."""
    out = {}
    for i, (arch, (cfg, params_np, tok, labels)) in enumerate(
            sorted(inputs.items())):
        out[arch] = mesh_train_step(mesh, cfg, params_np, tok, labels,
                                    steps=steps, rerun=i == 0)
    if train_dir is not None:
        out["train"] = mesh_train_loop(mesh, train_dir)
    return out


def train_loop_config(train_dir):
    """(model, batcher, TrainConfig) of the ``train(mesh=)`` case."""
    from repro_torch import configs as TC
    from repro_torch.data import LMBatcher, SyntheticLM
    from repro_torch.models import zoo as TZ
    from repro_torch.train import TrainConfig
    cfg = TC.get_reduced("stablelm_3b")
    tcfg = TrainConfig(steps=2, log_every=100, ckpt_every=100,
                       ckpt_dir=train_dir, warmup=1, seed=3)
    return TZ.build(cfg), LMBatcher(SyntheticLM(cfg.vocab, seed=0), 4, 16), \
        tcfg


def mesh_train_loop(mesh, train_dir):
    from repro_torch.train import train
    model, batcher, tcfg = train_loop_config(train_dir)
    res = train(model, batcher, tcfg, mesh=mesh, resume=False,
                device=mesh.device_type)
    return {"losses": res["losses"], "params": _full_np(res["params"], mesh)}


# -- serving over a mesh (launch/steps.build_decode_step, serve/, sae/) --------

# the decode cases: (arch, config changes). Reduced whisper drops its
# rules_overrides, which keep 12 heads off the production 16-way model
# axis: its 4 heads divide 2, so the cross memory splits by heads
DECODE_CASES = {
    "gemma_7b": ("gemma_7b", {}),
    "hymba_15b": ("hymba_15b", {}),
    "stablelm_3b": ("stablelm_3b", {}),
    "mamba2_370m": ("mamba2_370m", {}),
    "deepseek_plain": ("deepseek_v2_236b", {}),
    "deepseek_absorb": ("deepseek_v2_236b", {"mla_absorb": True}),
    "whisper_small": ("whisper_small", {"rules_overrides": ()}),
}
# (B, S) of each cell, shrunk as tests/test_multidevice.py:102-103 does
DECODE_CELLS = {"decode_32k": (8, 64), "long_500k": (1, 64)}
# the two calls' positions: a per-row vector (rows in the last slice, a
# window straddling a slice boundary, slices wholly masked), then a scalar
DECODE_POS = {"decode_32k": ([63, 33, 5, 40, 16, 31, 32, 0], 47),
              "long_500k": ([33], 63)}


def decode_config(name):
    import dataclasses
    from repro_torch import configs as TC
    arch, over = DECODE_CASES[name]
    return dataclasses.replace(TC.get_reduced(arch), **over)


def _seq_dim(path):
    """The sequence dim of a position-indexed cache leaf, else None."""
    if path.rsplit("/", 1)[-1] not in ("k", "v", "c", "kr"):
        return None
    return 2 if path.startswith("blocks/") else 1


def decode_inputs(name, cell, seed=0):
    """(numpy params, numpy cache, tokens (2, B, 1)) of one decode case:
    the port's draw; the cache f32, its positions below each row's first
    position filled from a seed (the rest zero), its other leaves (SSM
    state, conv tails, cross memory) filled whole."""
    from repro_torch._tree import flatten_with_path, tree_map, unflatten_like
    from repro_torch.models import zoo as TZ
    cfg = decode_config(name)
    model = TZ.build(cfg)
    params = model.init(torch.Generator().manual_seed(seed), device="cpu")
    B, S = DECODE_CELLS[cell]
    cache = model.init_cache(B, S, dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(seed + 1)
    first = np.broadcast_to(np.asarray(DECODE_POS[cell][0]), (B,))
    out = []
    for path, leaf in flatten_with_path(cache):
        a = rng.normal(size=tuple(leaf.shape)).astype(np.float32)
        d = _seq_dim(path)
        if d is not None:
            bdim = d - 1
            idx = np.arange(S).reshape((1,) * d + (S,) + (1,) * (
                a.ndim - d - 1))
            lim = first.reshape((1,) * bdim + (B,) + (1,) * (a.ndim - bdim
                                                              - 1))
            a = np.where(idx < lim, a, 0.0).astype(np.float32)
        out.append(a)
    tok = rng.integers(0, cfg.vocab, size=(2, B, 1))
    return (tree_map(lambda p: p.numpy(), params),
            unflatten_like(cache, out), tok)


def decode_gathers(specs, cfg):
    """(FSDP gathers, head gathers) of one decode call from the param
    specs ({path: spec}): a leaf split over data gathers once per layer it
    serves (the encoder's never); a head-split weight of an attention
    layer whose kv heads are whole (``wq`` / ``bq`` / ``wo``), and MLA's
    four head projections, gather over model once per layer (the decode
    rules give the model axis to the cache's sequence)."""
    def has(spec, axis):
        return any(a == axis or (isinstance(a, tuple) and axis in a)
                   for a in spec)

    layers = cfg.n_layers // len(cfg.pattern)
    fsdp = head = 0
    for path, spec in specs.items():
        if path.startswith("enc_"):
            continue
        n = layers if path.startswith("blocks/") else 1
        fsdp += n * has(spec, "data")
        region, leaf = path.split("/")[-2:]
        if region == "attn" and leaf in ("wq", "bq", "wo"):
            kv = specs[path.rsplit("/", 1)[0] + "/wk"]
            head += n * (has(spec, "model") and not has(kv, "model"))
        if region == "mla" and leaf in ("wq_b", "wk_b", "wv_b", "wo"):
            head += n * has(spec, "model")
    return fsdp, head


def _decode_positions(cell):
    vec, scalar = DECODE_POS[cell]
    return [torch.tensor(vec, dtype=torch.long), scalar]


def _whole_np(x, mesh):
    """A DTensor (or a tree of them) whole as numpy, on every rank."""
    from repro_torch._tree import tree_map
    from repro_torch.convert import params_from_mesh
    return tree_map(lambda t: t.float().cpu().numpy(),
                    params_from_mesh(x, mesh))


def mesh_decode(mesh, name, cell, params_np, cache_np, tok):
    """Two calls of ``build_decode_step(model, mesh, rules_for_cell(cfg,
    cell))`` from the case's cache laid out in pieces
    (``convert.cache_to_mesh``): per call the logits whole, the
    collectives by kind, every all_gather / all_to_all / all_reduce call;
    the cache whole after the calls; a rerun's pieces and logits
    (bit-equal flag); whether each piece kept its storage."""
    from repro_torch._tree import flatten_with_path, leaves, tree_map
    from repro_torch.convert import cache_to_mesh, params_to_mesh
    from repro_torch.dist import sharding as SH
    from repro_torch.dist.layout import local_of
    from repro_torch.launch import steps as ST
    from repro_torch.models import zoo as TZ
    cfg = decode_config(name)
    model = TZ.build(cfg)
    dev = mesh.device_type
    rules = ST.rules_for_cell(cfg, cell, False)
    specs = ST.param_shardings(model, mesh, rules)
    params = params_to_mesh(tree_map(torch.from_numpy, params_np), mesh,
                            specs, dev)
    full = tree_map(torch.from_numpy, cache_np)
    c_specs = ST.cache_shardings(full, mesh, rules)
    step = ST.build_decode_step(model, mesh, rules)

    def run(record):
        cache = cache_to_mesh(full, mesh, c_specs, dev)
        ptrs = [local_of(x).data_ptr() for x in leaves(cache)]
        logits, counts = [], []
        for t, pos in zip(tok, _decode_positions(cell)):
            SH.reset_collective_counts()
            gathers, a2a = _count_calls("all_gather"), _count_calls(
                "all_to_all_single")
            with recorded_collectives() as log, gathers, a2a:
                lg, out = step(params, cache, torch.from_numpy(t).to(dev),
                               pos)
            assert out is cache
            c = SH.collective_counts()
            c.update(all_gather_calls=gathers.n, all_to_all_calls=a2a.n,
                     all_reduce_calls=len(log.reduces))
            counts.append(c)
            logits.append(lg)
        same = ptrs == [local_of(x).data_ptr() for x in leaves(cache)]
        return logits, cache, counts, same

    logits, cache, counts, same = run(True)
    logits2, cache2, _, _ = run(False)
    rerun = all(torch.equal(local_of(a), local_of(b)) for a, b in zip(
        logits + leaves(cache), logits2 + leaves(cache2)))
    return {"logits": [_whole_np(lg, mesh) for lg in logits],
            "cache": dict(flatten_with_path(_whole_np(cache, mesh))),
            "counts": counts, "rerun_equal": rerun, "in_place": same,
            "specs": {k: tuple(v) for k, v in flatten_with_path(c_specs)},
            "param_specs": {k: tuple(v) for k, v in
                            flatten_with_path(specs)}}


def _planted_split_softmax(kind):
    """A broken split-softmax combine: "drop" loses the second shard's
    partial; "local_max" weighs each shard at its own max, so a wholly
    masked slice (all -1e30, its p all 1) weighs in."""
    from repro_torch.dist.sharding import seq_max, seq_sum
    from repro_torch.models import attention as A

    def combine(logits, weigh, split):
        if kind == "drop":
            m = seq_max(logits.amax(dim=-1), split)
            p = torch.exp(logits - m[..., None])
            part = torch.cat([weigh(p), p.sum(dim=-1)[..., None]], dim=-1)
            part = part * float(split.index != 1)
        else:
            p = torch.exp(logits - logits.amax(dim=-1)[..., None])
            part = torch.cat([weigh(p), p.sum(dim=-1)[..., None]], dim=-1)
        tot = seq_sum(part, split)
        return tot[..., :-1] / tot[..., -1:]

    return A, combine


def decode_group(mesh, inputs, shapes, faults=()):
    """The decode file's cases in one group of 4 ranks (``mesh`` is the
    group's (2, 2) mesh; each shape of ``shapes`` is built over the same
    ranks): ``mesh_decode`` of every (name, cell) of ``inputs`` on each
    (rank 0's whole results, the other ranks' counts); the refusal of a
    whole cache; then, on (2, 2), each planted fault of ``faults``
    ((kind, name, cell)) with ``_split_softmax`` replaced."""
    from repro_torch._tree import tree_map
    from repro_torch.convert import params_to_mesh
    from repro_torch.launch import steps as ST
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import zoo as TZ
    out = {}
    for shape in shapes:
        m = mesh if tuple(shape) == tuple(mesh.mesh.shape) else \
            make_local_mesh(*shape, device=mesh.device_type)
        for key, args in inputs.items():
            res = mesh_decode(m, *key, *args)
            out[(tuple(shape),) + key] = res if dist.get_rank() == 0 else {
                "counts": res["counts"]}
    # a whole cache (not laid out by cache_to_mesh) is refused
    name, cell = next(iter(inputs))
    params_np, cache_np, tok = inputs[(name, cell)]
    model = TZ.build(decode_config(name))
    rules = ST.rules_for_cell(model.cfg, cell, False)
    params = params_to_mesh(tree_map(torch.from_numpy, params_np), mesh,
                            ST.param_shardings(model, mesh, rules),
                            mesh.device_type)
    try:
        ST.build_decode_step(model, mesh, rules)(
            params, tree_map(torch.from_numpy, cache_np),
            torch.from_numpy(tok[0]), 0)
        out["whole_cache_refused"] = None
    except ValueError as e:
        out["whole_cache_refused"] = str(e)
    for kind, name, cell in faults:
        A, broken = _planted_split_softmax(kind)
        real = A._split_softmax
        A._split_softmax = broken
        try:
            res = mesh_decode(mesh, name, cell, *inputs[(name, cell)])
        finally:
            A._split_softmax = real
        out[("fault", kind, name, cell)] = {"logits": res["logits"]}
    return out


# the collectives a serving step could call
_ALL_COLLECTIVES = ("all_reduce", "all_gather", "all_gather_into_tensor",
                    "all_to_all_single", "broadcast", "reduce_scatter_tensor")


class _count_all:
    """Count every ``torch.distributed`` collective called inside the
    block (``.n``)."""

    def __enter__(self):
        self.parts = [_count_calls(n) for n in _ALL_COLLECTIVES]
        for p in self.parts:
            p.__enter__()
        return self

    def __exit__(self, *exc):
        for p in self.parts:
            p.__exit__(*exc)

    @property
    def n(self):
        return sum(p.n for p in self.parts)


def _count_in_steps(engine):
    """Wrap the engine's step so that the collectives called inside it
    are counted; returns the list that collects one count a step."""
    real, per_step = engine._traced_step, []

    def counted(*a, **kw):
        with _count_all() as c:
            real(*a, **kw)
        per_step.append(c.n)
    engine._traced_step = counted
    return per_step


def sae_serve(mesh, params, radius, x):
    """``make_serve_step(compact, mesh=)`` of the compacted SAE on ``x``:
    z and xhat_sel whole, the support, the collectives in the step, this
    rank's row count; and the refusals (rules mapping "batch" to None, a
    batch the ranks do not divide)."""
    from repro_torch._tree import tree_map
    from repro_torch.core import ProjectionSpec
    from repro_torch.dist import sharding as SH
    from repro_torch.dist.sharding import axes_index
    from repro_torch.sae import compact_sae, make_serve_step
    compact = compact_sae(tree_map(torch.from_numpy, params), (
        ProjectionSpec(pattern=r"enc1/w", norm="l1inf", radius=radius,
                       axis=1),))
    step = make_serve_step(compact, mesh=mesh)
    xt = torch.from_numpy(x).to(mesh.device_type)
    SH.reset_collective_counts()
    with _count_all() as calls:
        z, xh = step(compact.params, xt)
    out = {"z": _whole_np(z, mesh), "xh": _whole_np(xh, mesh),
           "sel": np.asarray(compact.sel), "calls": calls.n,
           "counts": SH.collective_counts(),
           "rows": tuple(z.to_local().shape)}
    for tag, call in (
            ("batch_none", lambda: make_serve_step(
                compact, mesh=mesh, rules={"batch": None})),
            ("indivisible", lambda: step(compact.params, xt[:axes_index(
                mesh, "data")[1] + 1]))):
        try:
            call()
            out[tag] = None
        except ValueError as e:
            out[tag] = str(e)
    return out


def lm_serve_config():
    """The port's twin of ``tests/_jax_serve_mesh.py``'s ``lm_config``:
    reduced gemma-7b at 2 layers with an l1,inf spec on ``mlp/w2`` too."""
    import dataclasses
    from repro_torch.configs import get_reduced
    from repro_torch.core import ProjectionSpec
    cfg = dataclasses.replace(get_reduced("gemma_7b"), n_layers=2)
    return dataclasses.replace(cfg, projection_specs=cfg.projection_specs
                               + (ProjectionSpec(pattern="blocks/.*/mlp/w2$",
                                                 norm="l1inf", radius=64.0,
                                                 axis=0, every_k=10),))


def batch_serve(mesh, cfg, params, prompts, max_new, compact):
    """``BatchServer(model, 8, ..., mesh=)``'s ``generate``: the tokens,
    the collectives inside each step, the engine's ``engine_out_gather``
    count against its steps, ``n_traces``."""
    from repro_torch._tree import tree_map
    from repro_torch.dist import sharding as SH
    from repro_torch.models import zoo as TZ
    from repro_torch.train.serve import BatchServer, ServeConfig
    srv = BatchServer(TZ.build(cfg), 8, ServeConfig(max_seq=32), mesh=mesh)
    p = tree_map(lambda a: torch.from_numpy(a).to(
        "cpu" if mesh is None else mesh.device_type), params)
    if compact:
        srv.load_compact(params=p)
    else:
        srv.load(p)
    in_step = _count_in_steps(srv.engine)
    SH.reset_collective_counts()
    tokens = srv.generate(prompts, max_new=max_new)
    st = srv.engine.stats()
    return {"tokens": tokens, "in_step": in_step,
            "gathers": SH.collective_counts().get("engine_out_gather", 0),
            "steps": st["steps"], "n_traces": srv.n_traces}


def engine_lifecycle(mesh, cfg, checkpoints, prompts, max_new):
    """A compact ``FleetEngine`` (8 slots) through load, refresh,
    cancel (one request in flight, one queued) and recompact mid-flight:
    every completion (rid, tokens, evicted, truncated), ``n_traces`` and
    the collectives inside each step. ``mesh=None``: the one-device run
    it is held to."""
    from repro_torch._tree import tree_map
    from repro_torch.models import zoo as TZ
    from repro_torch.serve.engine import EngineConfig, FleetEngine
    dev = "cpu" if mesh is None else mesh.device_type
    p1, p2, p3 = (tree_map(lambda a: torch.from_numpy(a).to(dev), c)
                  for c in checkpoints)
    eng = FleetEngine(TZ.build(cfg), 8, EngineConfig(max_seq=32), mesh=mesh)
    eng.load_compact(params=p1)
    in_step = _count_in_steps(eng)
    rids = [eng.submit(p, max_new) for p in prompts]
    done = []
    for _ in range(3):
        done += eng.step()
    eng.refresh(p2)
    for _ in range(2):
        done += eng.step()
    eng.cancel(rids[1])
    eng.cancel(rids[-1])
    eng.recompact(p3)
    done += eng.drain()
    return {"done": sorted((c.rid, c.tokens, c.evicted, c.truncated)
                           for c in done),
            "n_traces": eng.n_traces, "in_step": in_step}


def serve_group(mesh, shapes, sae, lm, hybrid, life):
    """The serve file's cases in one group of 4 ranks, on each mesh of
    ``shapes`` (built over the same ranks): the SAE serve step, the
    compact gemma ``BatchServer``, a dense hybrid ``BatchServer`` with more
    prompts than slots, and the compact engine's lifecycle."""
    from repro_torch.launch.mesh import make_local_mesh
    out = {}
    for shape in shapes:
        m = mesh if tuple(shape) == tuple(mesh.mesh.shape) else \
            make_local_mesh(*shape, device=mesh.device_type)
        out[tuple(shape)] = {
            "sae": sae_serve(m, **sae),
            "lm": batch_serve(m, lm_serve_config(), compact=True, **lm),
            "hybrid": batch_serve(m, hybrid_config(), compact=False,
                                  **hybrid),
            "life": engine_lifecycle(m, lm_serve_config(), **life)}
    return out


def hybrid_config():
    """Reduced hymba-1.5b at 2 layers (the SSM state and conv tails are
    the recurrent leaves an admitted slot zeroes)."""
    import dataclasses
    from repro_torch.configs import get_reduced
    return dataclasses.replace(get_reduced("hymba_15b"), n_layers=2)


def one_rank_steps(mesh, inputs, steps=2):
    """``build_train_step(model, mesh, rules)`` on a one-rank mesh for
    ``steps`` steps of each (name, (cfg, params, tok, labels)) of
    ``inputs``: per step the loss and the optimizer count, whether every
    returned param, mu and nu leaf is a ``DTensor`` with its input's
    placements and shape, then the leaves (each piece whole) as numpy."""
    from torch.distributed.tensor import DTensor
    from repro_torch._tree import flatten_with_path, leaves
    from repro_torch.convert import params_to_mesh
    from repro_torch.launch import steps as ST
    from repro_torch.models import zoo as TZ
    from repro_torch.optim import AdamConfig
    acfg = AdamConfig(moment_dtype=torch.float32)
    np_of = lambda t: {k: v.to_local().numpy().copy()
                       for k, v in flatten_with_path(t)}
    out = {}
    for name, (cfg, params_np, tok, labels) in sorted(inputs.items()):
        model = TZ.build(cfg)
        rules = ST.rules_for_cell(cfg, "train_4k", False)
        specs = ST.param_shardings(model, mesh, rules)
        params = params_to_mesh(params_np, mesh, specs, "cpu")
        opt = ST.shard_opt_state(params, acfg)
        proj = ST.projection_engine_for(cfg, mesh).init_state(params)
        step = ST.build_train_step(model, mesh, rules, acfg)
        batch = {"tokens": torch.from_numpy(tok).long(),
                 "labels": torch.from_numpy(labels).long()}
        losses, counts, laid_out, thetas = [], [], [], []
        for _ in range(steps):
            trio = lambda p, o: leaves(p) + leaves(o.mu) + leaves(o.nu)
            before = [(x.placements, x.shape) for x in trio(params, opt)]
            loss, _, params, opt, proj = step(params, opt, proj, batch)
            after = trio(params, opt)
            laid_out.append(all(
                isinstance(x, DTensor) and (x.placements, x.shape) == b
                for x, b in zip(after, before)))
            losses.append(float(loss))
            counts.append(int(opt.count))
            thetas.append({k: v.numpy().copy()
                           for k, v in flatten_with_path(proj)})
        out[name] = {"losses": losses, "counts": counts, "thetas": thetas,
                     "laid_out": laid_out, "params": np_of(params),
                     "mu": np_of(opt.mu), "nu": np_of(opt.nu)}
    return out
