"""The port's training substrate against ``repro``'s: the token pipeline,
checkpointing and the straggler watchdog.

* ``SyntheticLM``, ``MemmapSource``, ``LMBatcher`` and
  ``host_batch_slice`` give bit-equal arrays for the same (seed, step,
  rows).
* Checkpoints: round trip (bfloat16 stored widened, int32 count, 0-d
  leaves), integrity (crc32) and keep-last-k GC, the async checkpointer
  (snapshots are copies: updating the tree in place after ``save`` does
  not reach the files), mirroring ``tests/test_substrate.py``; a train
  state written by ``repro.checkpoint.save`` restores in the port with
  equal leaves and keys onto the template's dtype, and the reverse; the
  manifests of the two packages list the same keys, shapes and dtypes.
* ``StepWatchdog`` events and per-step metrics equal ``repro``'s under one
  injected clock: no sleeps, so nothing depends on wall-clock timing.
"""
import json
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.checkpoint import restore as jax_restore
from repro.checkpoint import restore_tree as jax_restore_tree
from repro.checkpoint import save as jax_save
from repro.data import pipeline as JP
from repro.dist.watchdog import StepWatchdog as JWatchdog
from repro.optim import AdamConfig as JAdamConfig
from repro.optim import adam_init as jax_adam_init
from repro_torch.checkpoint import (AsyncCheckpointer, gc_keep_last,
                                    latest_step, restore, restore_tree, save)
from repro_torch.data import pipeline as TP
from repro_torch.dist import StepWatchdog
from repro_torch.optim import adam_init


@pytest.mark.parametrize("seed,step,batch,seq,rows", [
    (1, 0, 2, 16, None), (3, 5, 8, 32, (2, 6)), (0, 123, 4, 2049, None)])
def test_synthetic_batches_bit_equal(seed, step, batch, seq, rows):
    want = JP.SyntheticLM(50304, seed=seed).batch(step, batch, seq, rows)
    got = TP.SyntheticLM(50304, seed=seed).batch(step, batch, seq, rows)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    jb = JP.LMBatcher(JP.SyntheticLM(1000, seed), batch, seq, rows).get(step)
    tb = TP.LMBatcher(TP.SyntheticLM(1000, seed), batch, seq, rows).get(step)
    assert sorted(tb) == sorted(jb) == ["labels", "tokens"]
    for k in jb:
        np.testing.assert_array_equal(tb[k], jb[k])


def test_memmap_source_and_host_slices_bit_equal(tmp_path):
    path = tmp_path / "tokens.bin"
    np.random.default_rng(0).integers(0, 60000, size=5000).astype(
        np.uint16).tofile(path)
    want = JP.MemmapSource(str(path), 60000, seed=2).batch(4, 6, 64)
    got = TP.MemmapSource(str(path), 60000, seed=2).batch(4, 6, 64)
    np.testing.assert_array_equal(got, want)
    for hosts in (1, 2, 4):
        for h in range(hosts):
            assert TP.host_batch_slice(8, hosts, h) == \
                JP.host_batch_slice(8, hosts, h)
    src = TP.SyntheticLM(vocab=1000, seed=3)
    halves = [src.batch(5, 8, 32, rows=TP.host_batch_slice(8, 2, h))
              for h in (0, 1)]
    np.testing.assert_array_equal(np.concatenate(halves),
                                  src.batch(5, 8, 32))
    batch = TP.LMBatcher(src, 4, 16).get(0)
    np.testing.assert_array_equal(batch["tokens"][:, 1:],
                                  batch["labels"][:, :-1])


def _tree():
    return {"a": {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4)},
            "b": torch.ones((5,), dtype=torch.bfloat16) * 1.5,
            "count": torch.tensor(7, dtype=torch.int32)}


def test_checkpoint_roundtrip(tmp_path):
    t = _tree()
    save(t, tmp_path, 3)
    save(t, tmp_path, 10)
    assert latest_step(tmp_path) == 10
    flat, step = restore(tmp_path)
    assert step == 10 and flat["b"].dtype == np.float32
    restored, step = restore_tree(t, tmp_path)
    for k in ("b", "count"):
        assert restored[k].dtype == t[k].dtype
        assert restored[k].shape == t[k].shape
        assert torch.equal(restored[k], t[k])
    assert torch.equal(restored["a"]["w"], t["a"]["w"])
    half = restore_tree({"a": {"w": torch.zeros((3, 4), dtype=torch.bfloat16)},
                         "b": torch.zeros(5), "count": torch.tensor(0)},
                        tmp_path)[0]
    assert half["a"]["w"].dtype == torch.bfloat16
    assert half["b"].dtype == torch.float32


def test_checkpoint_integrity_and_gc(tmp_path):
    t = _tree()
    for s in (1, 2, 3, 4):
        save(t, tmp_path, s)
    gc_keep_last(tmp_path, 2)
    assert latest_step(tmp_path) == 4
    assert sorted(p.name for p in pathlib.Path(tmp_path).iterdir()) == \
        ["step-00000003", "step-00000004"]
    restore(tmp_path, 3)
    with pytest.raises(FileNotFoundError):
        restore(str(tmp_path) + "-missing")
    target = next((pathlib.Path(tmp_path) / "step-00000004").glob("a__w.npy"))
    arr = np.load(target)
    arr.flat[0] += 1
    np.save(target, arr)
    with pytest.raises(IOError):
        restore(tmp_path, 4)
    with pytest.raises(KeyError, match="missing leaf"):
        restore_tree({"zz": torch.zeros(1)}, tmp_path, 3)


def test_async_checkpointer(tmp_path):
    c = AsyncCheckpointer(tmp_path, keep=2)
    t = _tree()
    for s in (5, 6, 7):
        c.save(t, s)
        t["a"]["w"].add_(1.0)          # in place, after the snapshot
    c.wait()
    assert latest_step(tmp_path) == 7
    assert sorted(p.name for p in pathlib.Path(tmp_path).iterdir()) == \
        ["step-00000006", "step-00000007"]
    flat, _ = restore(tmp_path, 7)
    np.testing.assert_array_equal(flat["a/w"],
                                  np.arange(12).reshape(3, 4) + 2.0)


def _state(seed=0):
    rng = np.random.default_rng(seed)
    params = {"blocks": {"p0_global": {"mlp": {"w1": rng.normal(
        size=(2, 4, 6)).astype(np.float32)}}},
              "embed": {"table": rng.normal(size=(8, 4)).astype(np.float32)},
              "norm": rng.normal(size=(4,)).astype(np.float32)}
    return params, {"l1inf_packed/k10": rng.uniform(size=(2,)).astype(
        np.float32)}


def test_jax_train_state_restores_in_port(tmp_path):
    params, proj = _state()
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jopt = jax_adam_init(jp, JAdamConfig())
    jopt = jopt._replace(count=jnp.asarray(4, jnp.int32),
                         mu=jax.tree_util.tree_map(lambda x: x + 1.0, jp))
    jax_save({"params": jp, "opt": jopt,
              "proj": jax.tree_util.tree_map(jnp.asarray, proj)}, tmp_path, 4)
    manifest = json.loads((pathlib.Path(tmp_path) / "step-00000004" /
                           "manifest.json").read_text())
    assert "opt/.count" in manifest["leaves"]
    assert "proj/l1inf_packed/k10" in manifest["leaves"]
    tp = {"blocks": {"p0_global": {"mlp": {"w1": torch.zeros(2, 4, 6)}}},
          "embed": {"table": torch.zeros(8, 4)}, "norm": torch.zeros(4)}
    template = {"params": tp, "opt": adam_init(tp),
                "proj": {"l1inf_packed/k10": torch.zeros(2)}}
    got, step = restore_tree(template, tmp_path)
    assert step == 4 and got["opt"].count.dtype == torch.int32
    assert int(got["opt"].count) == 4 and got["opt"].count.ndim == 0
    np.testing.assert_array_equal(got["params"]["blocks"]["p0_global"]["mlp"]
                                  ["w1"].numpy(),
                                  params["blocks"]["p0_global"]["mlp"]["w1"])
    np.testing.assert_array_equal(got["opt"].mu["norm"].numpy(),
                                  params["norm"] + 1.0)
    np.testing.assert_array_equal(got["proj"]["l1inf_packed/k10"].numpy(),
                                  proj["l1inf_packed/k10"])


def test_port_train_state_restores_in_jax(tmp_path):
    params, proj = _state(1)
    tp = {k: v for k, v in jax.tree_util.tree_map(torch.from_numpy,
                                                  params).items()}
    opt = adam_init(tp)._replace(count=torch.tensor(9, dtype=torch.int32))
    save({"params": tp, "opt": opt,
          "proj": {k: torch.from_numpy(v) for k, v in proj.items()}},
         tmp_path / "port", 9)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jax_save({"params": jp, "opt": jax_adam_init(jp, JAdamConfig())._replace(
        count=jnp.asarray(9, jnp.int32)),
              "proj": jax.tree_util.tree_map(jnp.asarray, proj)},
             tmp_path / "jax", 9)
    mine = json.loads((tmp_path / "port" / "step-00000009" /
                       "manifest.json").read_text())["leaves"]
    theirs = json.loads((tmp_path / "jax" / "step-00000009" /
                         "manifest.json").read_text())["leaves"]
    assert {k: (m["file"], m["shape"], m["dtype"]) for k, m in mine.items()} \
        == {k: (m["file"], m["shape"], m["dtype"])
            for k, m in theirs.items()}
    template = {"params": jax.tree_util.tree_map(jnp.zeros_like, jp),
                "opt": jax_adam_init(jp, JAdamConfig()),
                "proj": jax.tree_util.tree_map(jnp.zeros_like, proj)}
    got, step = jax_restore_tree(template, tmp_path / "port")
    assert step == 9 and int(got["opt"].count) == 9
    np.testing.assert_array_equal(np.asarray(got["params"]["embed"]["table"]),
                                  params["embed"]["table"])
    flat, _ = jax_restore(tmp_path / "port")
    assert sorted(flat) == sorted(theirs)


def _clock(times):
    it = iter(times)
    return lambda: next(it)


@pytest.mark.parametrize("threshold,grace,alpha", [(3.0, 1, 0.25),
                                                   (2.0, 3, 0.5)])
def test_watchdog_events_equal_reference(threshold, grace, alpha):
    """The same injected clock through both detectors: the same straggler
    events, EWMA and per-step metrics, a warm-up spike folded clamped and
    a straggler kept out of the EWMA."""
    durations = [0.002, 0.010, 0.002, 0.002, 0.003, 0.050, 0.002, 0.002,
                 0.020, 0.002]
    times, t = [], 100.0
    for d in durations:
        times += [t, t + d]
        t += d + 0.001
    events = {"jax": [], "port": []}
    dogs = {"jax": JWatchdog(threshold, grace, alpha, clock=_clock(times),
                             on_straggler=lambda s, dt, ew: events["jax"]
                             .append((s, dt, ew))),
            "port": StepWatchdog(threshold, grace, alpha,
                                 clock=_clock(times),
                                 on_straggler=lambda s, dt, ew:
                                 events["port"].append((s, dt, ew)))}
    metrics = {"jax": [], "port": []}
    for name, dog in dogs.items():
        for step in range(len(durations)):
            dog.start()
            dog.stop(step)
            metrics[name].append(dog.metrics())
    assert events["port"] == events["jax"] and events["port"]
    assert dogs["port"].events == dogs["jax"].events
    assert metrics["port"] == metrics["jax"]
    assert 5 in [e[0] for e in events["port"]]
    with pytest.raises(RuntimeError):
        StepWatchdog().stop(0)
