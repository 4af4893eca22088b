"""Checkpoint and restore (the reference's ``checkpoint/manager.py``), in the
reference's on-disk format, so either package restores the other's
checkpoints:

  * a checkpoint is a directory ``step_<N>/`` (N in 8 digits) holding one
    ``.npy`` file a leaf, named after the leaf's path as
    ``jax.tree_util.keystr`` writes it (``['opt'].mu['embed']``, characters
    outside ``[A-Za-z0-9_.-]`` as ``_``), and ``manifest.json`` (each leaf's
    key, file, shape and dtype name, the step, ``extra``);
  * types numpy lacks (bf16) are stored as their raw bytes, an extra last
    axis of ``itemsize`` uint8, under their dtype name (``bfloat16``);
  * a save writes ``step_<N>.tmp`` and renames it, so a crash mid-write never
    leaves a partial checkpoint;
  * :class:`CheckpointManager` copies the tree to the host at ``save`` (the
    train step then updates the parameters in place) and writes it on a
    thread; ``wait`` joins it and raises what it raised.  It keeps the
    newest ``keep`` checkpoints.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.common.tree import tree_items, tree_map

_NATIVE = {"float64", "float32", "float16", "int64", "int32", "int16", "int8",
           "uint64", "uint32", "uint16", "uint8", "bool"}
_TORCH_DTYPES = {torch.float64: "float64", torch.float32: "float32", torch.float16: "float16",
                 torch.bfloat16: "bfloat16", torch.int64: "int64", torch.int32: "int32",
                 torch.int16: "int16", torch.int8: "int8", torch.uint8: "uint8",
                 torch.bool: "bool"}
_BY_NAME = {name: dt for dt, name in _TORCH_DTYPES.items()}


def _safe_name(key: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.-]", "_", key)


def _to_host(leaf: Any, copy: bool = False) -> torch.Tensor:
    """A leaf as a tensor on the host (a copy of a device tensor; of a host
    tensor too with ``copy``)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=copy)
    return torch.as_tensor(np.array(leaf))


def _encode(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """(the array to store, the dtype name): bf16 as its raw bytes."""
    name = _TORCH_DTYPES[t.dtype]
    if name in _NATIVE:
        return t.numpy(), name
    raw = t.contiguous().reshape(-1).view(torch.uint8)
    return raw.numpy().reshape(tuple(t.shape) + (t.element_size(),)), name


def _decode(arr: np.ndarray, dtype_name: str, shape: tuple) -> torch.Tensor:
    t = torch.from_numpy(np.array(arr, order="C"))  # ascontiguousarray would make 0-d 1-d
    if dtype_name in _NATIVE:
        return t
    return t.reshape(-1).view(_BY_NAME[dtype_name]).reshape(shape)


def save_pytree(tree: Any, directory: str, *, step: int, extra: Optional[dict] = None) -> str:
    """Synchronous atomic save.  Returns the final checkpoint path."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "leaves": [], "extra": extra or {}, "hosts": 1}
    for key, leaf in tree_items(tree):
        arr, dtype_name = _encode(_to_host(leaf))
        fname = _safe_name(key) + ".npy"
        np.save(os.path.join(tmp, fname), arr)
        shape = list(arr.shape[:-1]) if dtype_name not in _NATIVE else list(arr.shape)
        manifest["leaves"].append({"key": key, "file": fname, "shape": shape,
                                   "dtype": dtype_name})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def load_pytree(path: str, like: Any) -> tuple[Any, dict]:
    """Restore into the structure of ``like``: each leaf in the type of
    ``like``'s leaf (converted if the checkpoint holds another) on its
    device.  A leaf the checkpoint lacks raises ``KeyError``, one of another
    shape ``ValueError``.  Returns (tree, extra)."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    by_key = {leaf["key"]: leaf for leaf in manifest["leaves"]}
    out = []
    for key, leaf in tree_items(like):
        meta = by_key.get(key)
        if meta is None:
            raise KeyError(f"checkpoint at {path} is missing leaf {key}")
        t = _decode(np.load(os.path.join(path, meta["file"])), meta["dtype"],
                    tuple(meta["shape"]))
        want = tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(np.shape(leaf))
        if tuple(t.shape) != want:
            raise ValueError(f"checkpoint at {path} holds leaf {key} of shape "
                             f"{tuple(t.shape)}, expected {want}")
        if isinstance(leaf, torch.Tensor):
            t = t.to(device=leaf.device, dtype=leaf.dtype)
        out.append(t)
    values = iter(out)
    return tree_map(lambda _: next(values), like), manifest["extra"]


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3, async_writes: bool = True):
        self.directory = directory
        self.keep = keep
        self.async_writes = async_writes
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(directory, exist_ok=True)

    # -- discovery
    def all_steps(self) -> list[int]:
        steps = []
        for name in os.listdir(self.directory):
            m = re.fullmatch(r"step_(\d+)", name)
            if m:
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def path_for(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}")

    # -- save
    def save(self, tree: Any, step: int, extra: Optional[dict] = None):
        self.wait()
        host_tree = tree_map(lambda t: _to_host(t, copy=True), tree)  # taken now

        def work():
            try:
                save_pytree(host_tree, self.directory, step=step, extra=extra)
                self._gc()
            except BaseException as e:  # noqa: BLE001  (raised again by wait())
                self._error = e

        if self.async_writes:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
        else:
            work()
            self._raise_if_failed()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._raise_if_failed()

    def _raise_if_failed(self):
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(self.path_for(s), ignore_errors=True)

    # -- restore
    def restore(self, like: Any, *, step: Optional[int] = None) -> tuple[Any, dict, int]:
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        tree, extra = load_pytree(self.path_for(step), like)
        return tree, extra, step
