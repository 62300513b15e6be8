"""numpy checkpoints with a manifest, an atomic rename and an async writer
(counterpart of ``repro.checkpoint.store``), in the reference's on-disk
layout, so a checkpoint crosses between the packages
(``checkpoint.convert`` changes the tree's layout on the way):

    <dir>/step_<N>/arrays.npz + manifest.json ; <dir>/LATEST names the
    newest complete step (written last, so a crash mid-write never
    corrupts the restore path).

Each leaf is one array, keyed by its path (dict keys and list indices)
joined by ``//``.  numpy has no bfloat16: a bf16 leaf is saved as its
``uint16`` bits, with the true type recorded in ``__dtypes__``.  The
reference restores that through ``ml_dtypes``; here the bits come back
through ``torch.from_numpy(u16.view(np.int16)).view(torch.bfloat16)``.
``restore`` puts each leaf on its template leaf's device, and a leaf whose
template is not a tensor (a ``runtime.sharding.Placed``) stays on the
host: ``runtime.train.Trainer.restore`` places those on its mesh, as the
reference's ``place`` re-shards.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.tree import tree_map, tree_paths, tree_unflatten

_SEP = "//"


def _key(path) -> str:
    return _SEP.join(str(e) for e in path)


def _host(leaf) -> np.ndarray:
    """A leaf as a numpy array (a bf16 tensor as its uint16 bits)."""
    if torch.is_tensor(leaf):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.asarray(leaf)


def _type_name(leaf) -> str:
    if torch.is_tensor(leaf):
        return str(leaf.dtype).replace("torch.", "")
    return str(np.asarray(leaf).dtype)


def _flatten(tree: Any) -> Dict[str, np.ndarray]:
    flat, dtypes = {}, {}
    for path, leaf in tree_paths(tree):
        key = _key(path)
        dtypes[key] = _type_name(leaf)
        flat[key] = _host(leaf)
    flat["__dtypes__"] = np.frombuffer(json.dumps(dtypes).encode(), dtype=np.uint8)
    return flat


def _leaf(arr: np.ndarray, want: Optional[str]) -> torch.Tensor:
    if want == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    if want is not None and want != str(arr.dtype):
        raise ValueError(f"stored as {arr.dtype}, recorded as {want}: not a type "
                         f"this package restores")
    return torch.from_numpy(arr)


def _unflatten_into(template: Any, arrays: Dict[str, np.ndarray]) -> Any:
    dtypes = {}
    if "__dtypes__" in arrays:
        dtypes = json.loads(bytes(arrays["__dtypes__"]).decode())
    leaves = []
    for path, like in tree_paths(template):
        key = _key(path)
        t = _leaf(arrays[key], dtypes.get(key))
        leaves.append(t.to(like.device) if torch.is_tensor(like) else t)
    return tree_unflatten(template, leaves)


def save(ckpt_dir: str, step: int, tree: Any, extra: Optional[Dict] = None) -> str:
    """Blocking save; returns the step directory."""
    step_dir = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp_dir = step_dir + ".tmp"
    os.makedirs(tmp_dir, exist_ok=True)
    flat = _flatten(tree)
    np.savez(os.path.join(tmp_dir, "arrays.npz"), **flat)
    manifest = {"step": step, "num_arrays": len(flat), **(extra or {})}
    with open(os.path.join(tmp_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(step_dir):
        shutil.rmtree(step_dir)  # idempotent re-save of the same step
    os.replace(tmp_dir, step_dir)
    with open(os.path.join(ckpt_dir, "LATEST.tmp"), "w") as f:
        f.write(os.path.basename(step_dir))
    os.replace(os.path.join(ckpt_dir, "LATEST.tmp"), os.path.join(ckpt_dir, "LATEST"))
    return step_dir


class AsyncWriter:
    """One-in-flight background checkpoint writer: the tree is copied to
    host memory on the caller's thread (so later in-place updates cannot
    reach the snapshot); only the file IO runs off-thread."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None
        self.last_step: Optional[int] = None

    def save(self, ckpt_dir: str, step: int, tree: Any, extra=None) -> None:
        self.wait()
        host_tree = tree_map(lambda x: x.detach().to("cpu", copy=True)
                             if torch.is_tensor(x) else x, tree)

        def write():
            try:
                save(ckpt_dir, step, host_tree, extra)
            except Exception as e:  # noqa: BLE001 -- re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=write, daemon=True)
        self._thread.start()
        self.last_step = step

    def wait(self) -> None:
        """Join the write in flight; raise its error, if it failed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err


def latest_step(ckpt_dir: str) -> Optional[int]:
    path = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        name = f.read().strip()
    return int(name.split("_")[-1])


def restore(ckpt_dir: str, template: Any, step: Optional[int] = None) -> Tuple[int, Any]:
    """Load step ``step`` (default: ``LATEST``) into the structure of
    ``template``, each leaf on its template leaf's device."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    step_dir = os.path.join(ckpt_dir, f"step_{step:08d}")
    with np.load(os.path.join(step_dir, "arrays.npz")) as npz:
        arrays = {k: npz[k] for k in npz.files}
    return step, _unflatten_into(template, arrays)
