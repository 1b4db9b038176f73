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
from repro_torch.sae import SAEConfig, SAETrainConfig, sae_init, train_sae

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
                 "repro_torch.sae.train", "repro_torch.optim.schedule"):
        assert want in names


def _imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_jax_or_repro_import_in_source():
    """AST scan: no absolute import of jax or repro anywhere in the
    package (relative imports stay inside repro_torch)."""
    bad = []
    for dirpath, _, files in os.walk(_PKG):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
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
                                   "opt_state_from_numpy", "train_sae"])
def test_entry_point_without_device_raises(no_cuda, entry):
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
    }
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[entry]()


def test_explicit_cpu_device_runs(no_cuda):
    p = sae_init(SAEConfig(n_features=4, n_hidden=2),
                 generator=torch.Generator().manual_seed(0), device="cpu")
    assert p["enc1"]["w"].shape == (4, 2) and p["enc1"]["w"].device.type \
        == "cpu"


@pytest.mark.parametrize("call", ["colstats", "mu_solve", "clip_apply"])
def test_kernel_wrapper_refuses_other_devices(call):
    """Only a CPU tensor takes the plain version; any device that is not
    the card raises instead of computing elsewhere."""
    Y = torch.ones((8, 4), device="meta")
    mu = torch.ones((4,), device="meta")
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
