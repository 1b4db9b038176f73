"""The port's package boundary: ``repro_torch`` imports neither ``jax``
nor ``repro`` (at import time or later), and its entry points refuse to
fall back to the CPU when no device was asked for and CUDA is missing."""
import ast
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.convert import opt_state_from_numpy, params_from_numpy
from repro_torch.kernels.l1inf import kernel as K
from repro_torch.configs import get_reduced
from repro_torch.models import build, make_batch
from repro_torch.core import ProjectionSpec
from repro_torch.data import LMBatcher, SyntheticLM
from repro_torch.train import TrainConfig, train
from repro_torch.launch import train as launch_train
from repro_torch.sae import (SAEConfig, SAETrainConfig, compact_sae,
                             make_serve_step, sae_init, train_sae)

_PKG = os.path.dirname(repro_torch.__file__)
_SRC = os.path.dirname(_PKG)


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages([_PKG],
                                                        "repro_torch."))


def test_imports_with_jax_and_repro_blocked():
    """Every module imports in a fresh interpreter where importing ``jax``
    or ``repro`` raises."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        f"sys.path.insert(0, {_SRC!r})\n"
        "import importlib, repro_torch\n"
        f"for name in {_modules()!r}:\n"
        "    importlib.import_module(name)\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'repro.'))\n"
        "               for k, v in sys.modules.items() if v is not None)\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_every_module_listed():
    names = _modules()
    for want in ("repro_torch._build", "repro_torch.convert",
                 "repro_torch.core.engine", "repro_torch.kernels.l1inf.ops",
                 "repro_torch.kernels.fused_step.ops",
                 "repro_torch.core.l12", "repro_torch.core.bilevel",
                 "repro_torch.core.masked", "repro_torch.core.hoyer",
                 "repro_torch.core.weighted",
                 "repro_torch.sae.train", "repro_torch.optim.schedule",
                 "repro_torch.models.zoo", "repro_torch.configs",
                 "repro_torch.kernels.flash_attention.ops",
                 "repro_torch.kernels.ssd.ops",
                 "repro_torch.core.heap", "repro_torch.core.baselines",
                 "repro_torch.serve", "repro_torch.serve.compact",
                 "repro_torch.serve.refresh", "repro_torch.sae.serve",
                 "repro_torch.data", "repro_torch.data.pipeline",
                 "repro_torch.checkpoint", "repro_torch.checkpoint.ckpt",
                 "repro_torch.dist", "repro_torch.dist.watchdog",
                 "repro_torch.dist.projection", "repro_torch.dist.layout",
                 "repro_torch.dist.compression", "repro_torch.launch.mesh",
                 "repro_torch.train", "repro_torch.train.loop",
                 "repro_torch.serve.engine", "repro_torch.train.serve",
                 "repro_torch.models.moe", "repro_torch.models.blockcheck",
                 "repro_torch.launch", "repro_torch.launch.steps",
                 "repro_torch.launch.train"):
        assert want in names


def _imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


# the port's own scripts, which must not import JAX or the JAX package
_SCRIPTS = [os.path.join(os.path.dirname(_SRC), f)
            for f in ("chip_smoke.py",
                      os.path.join("scripts", "torch_profile.py"),
                      os.path.join("scripts", "torch_kernel_variants.py"),
                      os.path.join("scripts", "torch_sorted_time.py"),
                      os.path.join("scripts", "torch_lm_compact_probe.py"))]


def test_no_jax_or_repro_import_in_source():
    """AST scan: no absolute import of jax or repro anywhere in the
    package (relative imports stay inside repro_torch), in chip_smoke.py
    or in the port's scripts (scripts/torch_*.py)."""
    paths = [os.path.join(d, f) for d, _, files in os.walk(_PKG)
             for f in files if f.endswith(".py")] + _SCRIPTS
    assert all(os.path.exists(p) for p in _SCRIPTS), _SCRIPTS
    bad = []
    for path in paths:
        with open(path) as fh:
            tree = ast.parse(fh.read(), path)
        for name in _imports(tree):
            root = name.split(".")[0]
            if root in ("jax", "jaxlib", "repro"):
                bad.append((path, name))
    assert not bad, bad


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


_TREE = {"enc1": {"w": np.ones((3, 2), np.float32)}}


@pytest.mark.parametrize("entry", ["resolve_device", "sae_init",
                                   "params_from_numpy",
                                   "opt_state_from_numpy", "train_sae",
                                   "model_init", "init_cache", "make_batch",
                                   "train", "launch_train"])
def test_entry_point_without_device_raises(no_cuda, entry):
    model = build(get_reduced("hymba_15b"))
    calls = {
        "resolve_device": lambda: repro_torch.resolve_device(),
        "sae_init": lambda: sae_init(SAEConfig(n_features=4, n_hidden=2),
                                     generator=torch.Generator()),
        "params_from_numpy": lambda: params_from_numpy(_TREE),
        "opt_state_from_numpy": lambda: opt_state_from_numpy(
            (np.int32(0), _TREE, _TREE)),
        "train_sae": lambda: train_sae(
            np.ones((4, 3), np.float32), np.zeros(4, np.int64),
            np.ones((2, 3), np.float32), np.zeros(2, np.int64),
            SAEConfig(n_features=3, n_hidden=2), SAETrainConfig(epochs=1)),
        "model_init": lambda: model.init(torch.Generator()),
        "init_cache": lambda: model.init_cache(2, 8),
        "make_batch": lambda: make_batch(model.cfg, 2, 8),
        "train": lambda: train(build(get_reduced("stablelm_3b")),
                               LMBatcher(SyntheticLM(128), 2, 8),
                               TrainConfig(steps=1)),
        "launch_train": lambda: launch_train.main(
            ["--arch", "stablelm_3b", "--reduced", "--steps", "1"]),
    }
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[entry]()


def test_explicit_cpu_device_runs(no_cuda):
    p = sae_init(SAEConfig(n_features=4, n_hidden=2),
                 generator=torch.Generator().manual_seed(0), device="cpu")
    assert p["enc1"]["w"].shape == (4, 2) and p["enc1"]["w"].device.type \
        == "cpu"


@pytest.mark.parametrize("entry", ["compact_sae", "make_serve_step"])
def test_serving_entry_points_stay_on_the_params_device(no_cuda, entry):
    """The serving entry points take no ``device=``: they put the ``sel``
    leaf and every output on the device of the params they are given, and
    with CPU params they run with CUDA missing."""
    p = sae_init(SAEConfig(n_features=6, n_hidden=3),
                 generator=torch.Generator().manual_seed(0), device="cpu")
    p["enc1"]["w"][1] = 0.0
    spec = ProjectionSpec(pattern=r"enc1/w", norm="l1inf", radius=1e9,
                          axis=1)
    compact = compact_sae(p, (spec,))
    outs = {"compact_sae": [compact.params["sel"]]
            + list(compact.apply(compact.select(torch.ones(2, 6)))),
            "make_serve_step": list(make_serve_step(compact)(
                compact.params, torch.ones(2, 6)))}[entry]
    assert compact.n_selected == 5
    assert all(t.device.type == "cpu" for t in outs)


class _Elsewhere(torch.Tensor):
    """A tensor of ``like``'s shape and dtype on a device with neither a
    kernel nor a plain version (meta is the dry-run's now): metadata only,
    any op on it raises."""

    @staticmethod
    def __new__(cls, like):
        return torch.Tensor._make_wrapper_subclass(
            cls, like.shape, dtype=like.dtype, device=torch.device("xpu"))

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        raise RuntimeError(f"{func} on a stand-in device")


@pytest.mark.parametrize("call", ["colstats", "mu_solve", "clip_apply"])
def test_kernel_wrapper_refuses_other_devices(call):
    """Only a CPU tensor takes the plain version; any device that is not
    the card or meta (the dry-run's shape rule) raises instead of
    computing elsewhere."""
    Y = _Elsewhere(torch.ones((8, 4)))
    mu = _Elsewhere(torch.ones((4,)))
    fn = {"colstats": lambda: K.colstats(Y),
          "mu_solve": lambda: K.mu_solve(Y, 1.0, block_m=4),
          "clip_apply": lambda: K.clip_apply(Y, mu)}[call]
    with pytest.raises(ValueError, match="no kernel or plain version"):
        fn()


@pytest.mark.parametrize("bad", ["dtype", "noncontig", "ndim"])
def test_kernel_wrapper_checks_inputs(bad):
    Y = {"dtype": torch.ones((8, 4), dtype=torch.float64),
         "noncontig": torch.ones((4, 8)).T,
         "ndim": torch.ones((8,))}[bad]
    with pytest.raises((TypeError, ValueError)):
        K.colstats(Y)
