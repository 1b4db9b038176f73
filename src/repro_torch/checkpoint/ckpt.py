"""Fault-tolerant checkpointing (port of ``repro.checkpoint.ckpt``), in the
JAX package's on-disk format, so a checkpoint that either package writes
restores in the other:

  * one ``step-%08d`` directory per checkpoint, written to
    ``<dir>/.tmp-<step>`` and renamed into place (atomic);
  * one ``.npy`` file per leaf, named by its key with ``/`` -> ``__``, and
    ``manifest.json`` with each leaf's file, shape, original dtype and
    crc32, checked on restore;
  * bfloat16 stored widened to float32, its dtype recorded for the
    restore-time cast;
  * leaf keys as ``jax.tree_util`` paths print: dict keys as they are,
    NamedTuple fields with a leading dot. A train state is
    ``params/blocks/p0_global/mlp/w1``, ``opt/.count``, ``opt/.mu/...``,
    ``opt/.nu/...`` and ``proj/<plan key>``;
  * ``AsyncCheckpointer`` copies to host memory synchronously and writes
    to disk on a worker thread; keep-last-k garbage collection.

Trees are nested dicts and NamedTuples of torch tensors (any device).
``restore_tree`` puts each leaf on its template leaf's device and dtype.
"""
from __future__ import annotations

import json
import os
import pathlib
import re
import shutil
import threading
import zlib
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["save", "restore", "restore_tree", "latest_step", "gc_keep_last",
           "AsyncCheckpointer"]

_MANIFEST = "manifest.json"


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """[(key, leaf)] in ``jax.tree_util``'s order and key spelling."""
    join = lambda part: f"{prefix}/{part}" if prefix else part
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _flatten(tree[k], join(str(k)))]
    if _is_namedtuple(tree):
        return [kv for f in tree._fields
                for kv in _flatten(getattr(tree, f), join(f".{f}"))]
    return [(prefix, tree)]


def _rebuild(template, it):
    """A tree shaped like ``template`` whose leaves come from ``it`` in
    flattening order."""
    if isinstance(template, dict):
        return {k: _rebuild(template[k], it) for k in sorted(template)}
    if _is_namedtuple(template):
        return type(template)(*(_rebuild(getattr(template, f), it)
                                for f in template._fields))
    return next(it)


def _host(leaf: torch.Tensor) -> Tuple[np.ndarray, str]:
    """(host array as stored, original dtype name). bfloat16 is widened to
    float32, which holds each of its values exactly."""
    t = leaf.detach()
    if t.dtype == torch.bfloat16:
        return t.float().cpu().numpy(), "bfloat16"
    arr = t.cpu().numpy()
    return arr, str(arr.dtype)


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).reshape(-1).view(np.uint8))


def save(tree: Any, directory: str, step: int) -> str:
    """Synchronous atomic save. Returns the final checkpoint path.

    >>> save({"params": params, "opt": opt, "proj": proj}, "ckpt", 10)
    """
    directory = pathlib.Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    tmp = directory / f".tmp-{step}"
    final = directory / f"step-{step:08d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    manifest = {"step": step, "leaves": {}}
    for key, leaf in _flatten(tree):
        arr, orig_dtype = _host(leaf)
        fname = key.replace("/", "__") + ".npy"
        np.save(tmp / fname, arr)
        manifest["leaves"][key] = {
            "file": fname, "shape": list(arr.shape), "dtype": orig_dtype,
            "crc32": _crc(arr)}
    (tmp / _MANIFEST).write_text(json.dumps(manifest, indent=1))
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)
    return str(final)


def restore(directory: str, step: Optional[int] = None,
            verify: bool = True) -> Tuple[dict, int]:
    """Restore a flat {key: np.ndarray} dict + step (leaves as stored:
    bfloat16 widened). Raises FileNotFoundError when there is no
    checkpoint and IOError on a crc mismatch."""
    directory = pathlib.Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    path = directory / f"step-{step:08d}"
    manifest = json.loads((path / _MANIFEST).read_text())
    out = {}
    for key, meta in manifest["leaves"].items():
        arr = np.load(path / meta["file"])
        if verify:
            crc = _crc(arr)
            if crc != meta["crc32"]:
                raise IOError(f"checkpoint corruption in {key} "
                              f"(crc {crc} != {meta['crc32']})")
        out[key] = arr
    return out, manifest["step"]


def restore_tree(template: Any, directory: str, step: Optional[int] = None
                 ) -> Tuple[Any, int]:
    """Restore into the structure of ``template``: each leaf on its
    template leaf's device and in its dtype. Raises KeyError naming a leaf
    of the template that the checkpoint lacks.

    >>> state, step = restore_tree({"params": params, "opt": opt}, "ckpt")
    """
    flat_np, step = restore(directory, step)
    leaves = []
    for key, tmpl in _flatten(template):
        if key not in flat_np:
            raise KeyError(f"checkpoint missing leaf {key}")
        leaves.append(torch.from_numpy(np.require(flat_np[key],
                                                  requirements="C"))
                      .to(device=tmpl.device, dtype=tmpl.dtype))
    return _rebuild(template, iter(leaves)), step


def latest_step(directory) -> Optional[int]:
    directory = pathlib.Path(directory)
    if not directory.exists():
        return None
    steps = []
    for p in directory.iterdir():
        m = re.fullmatch(r"step-(\d+)", p.name)
        if m and (p / _MANIFEST).exists():
            steps.append(int(m.group(1)))
    return max(steps) if steps else None


def gc_keep_last(directory, k: int = 3):
    directory = pathlib.Path(directory)
    steps = sorted(
        int(re.fullmatch(r"step-(\d+)", p.name).group(1))
        for p in directory.iterdir()
        if re.fullmatch(r"step-(\d+)", p.name))
    for s in steps[:-k]:
        shutil.rmtree(directory / f"step-{s:08d}", ignore_errors=True)


class AsyncCheckpointer:
    """Snapshot to host memory synchronously, write to disk on a worker
    thread (one write outstanding; an error surfaces on the next
    ``save`` or ``wait``)."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, tree: Any, step: int):
        self.wait()  # one outstanding write at a time
        # copies, also of CPU tensors: the train loop updates its state in
        # place while the worker writes
        host = _rebuild(tree, iter(leaf.detach().to("cpu", copy=True)
                                   for _, leaf in _flatten(tree)))

        def work():
            try:
                save(host, self.directory, step)
                gc_keep_last(self.directory, self.keep)
            except BaseException as e:  # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
