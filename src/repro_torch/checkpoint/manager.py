"""Atomic, self-verifying, asynchronous checkpoints of the training state
(the JAX package's ``checkpoint/manager.py`` over PyTorch trees).

A tree is nested dicts, tuples (``AdamWState`` included), ``nn.Module``s
(their ``state_dict``), tensors and numpy arrays. The format is the JAX
package's: one ``arrays.npz`` of the leaves under their "/"-joined paths
(bf16 stored as its uint16 bits under ``<key>::bf16``) and a
``MANIFEST.json`` with a checksum per array.

* **Atomic**: written to a temporary directory, fsynced, then renamed; a
  crash mid-save never corrupts the newest checkpoint.
* **Self-verifying**: restore checks every checksum and falls back to the
  previous step when a checkpoint is corrupt.
* **Async**: ``save(..., blocking=False)`` copies to the host, then writes
  in a background thread while training goes on.
* **Bounded**: keeps the newest ``keep`` checkpoints.
* **Elastic**: on a mesh, ``save(..., shardings=)`` gathers each leaf's
  full array from the ranks' blocks and rank 0 writes them in the
  one-device format; ``restore(like, shardings=)`` reads the full arrays
  and places this rank's blocks under the *current* mesh's shardings. A
  checkpoint written on a 2 x 2 mesh resumes on one device, and the other
  way round.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn


def _leaves(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(path, leaf) in a fixed order; dicts and modules by key, tuples by
    :func:`_parts`."""
    if isinstance(tree, nn.Module):
        tree = tree.state_dict()
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}" if prefix else str(k))
    elif isinstance(tree, tuple):
        for part, v in zip(_parts(tree), tree):
            yield from _leaves(v, f"{prefix}/{part}" if prefix else part)
    elif tree is not None:
        yield prefix, tree


def _parts(tup: tuple):
    """Path parts of a tuple's items, as JAX names them: ``.field`` for a
    named tuple (``AdamWState``), ``[i]`` otherwise."""
    fields = getattr(tup, "_fields", None)
    return [f".{f}" for f in fields] if fields else [f"[{i}]" for i in range(len(tup))]


def _to_numpy(leaf) -> Tuple[str, np.ndarray]:
    """(key suffix, host array); bf16 as its uint16 bits."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            return "::bf16", t.view(torch.int16).cpu().numpy().view(np.uint16)
        return "", t.cpu().numpy()
    return "", np.asarray(leaf)


def _flatten(tree: Any) -> Dict[str, np.ndarray]:
    flat = {}
    for key, leaf in _leaves(tree):
        suffix, arr = _to_numpy(leaf)
        flat[key + suffix] = arr
    return flat


def _shardings(shardings: Any) -> Dict[str, Any]:
    """path -> NamedSharding of a tree of shardings shaped like the saved
    tree (dicts keyed like a module's parameters, ``AdamWState`` with
    ``step=None``); leaves without one are absent."""
    if shardings is None:
        return {}
    out: Dict[str, Any] = {}

    def walk(tree, prefix):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, f"{prefix}/{k}" if prefix else str(k))
        elif isinstance(tree, tuple) and not hasattr(tree, "spec"):
            for part, v in zip(_parts(tree), tree):
                walk(v, f"{prefix}/{part}" if prefix else part)
        elif tree is not None:
            out[prefix] = tree

    walk(shardings, "")
    return out


def _gathered(tree: Any, shardings: Any) -> Any:
    """``tree``'s leaves as full tensors: each sharded leaf gathered from the
    ranks' blocks (collective), the others as they are."""
    from ..distributed.collectives import comm_for
    from ..distributed.sharding import gather_full

    by_path = _shardings(shardings)
    flat = {}
    for key, leaf in _leaves(tree):
        sh = by_path.get(key)
        if sh is not None and isinstance(leaf, torch.Tensor):
            leaf = gather_full(leaf, sh.spec, comm_for(sh.mesh))
        flat[key] = leaf
    return flat


def _is_writer(shardings: Any) -> bool:
    """Whether this process writes: rank 0 of a sharded save, or any
    process of an unsharded one."""
    return shardings is None or not (dist.is_available() and dist.is_initialized()) \
        or dist.get_rank() == 0


def _checksum(arr: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()[:1_000_000]).hexdigest()[:16]


class CheckpointManager:
    def __init__(self, directory: str | os.PathLike, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------
    def _step_dir(self, step: int) -> Path:
        return self.dir / f"step_{step:010d}"

    def all_steps(self):
        out = []
        for d in sorted(self.dir.glob("step_*")):
            if (d / "MANIFEST.json").exists():
                out.append(int(d.name.split("_")[1]))
        return out

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # ------------------------------------------------------------------
    def _write(self, step: int, flat: Dict[str, np.ndarray], extra: Dict):
        tmp = self.dir / f".tmp_step_{step:010d}_{os.getpid()}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = {"step": step, "time": time.time(), "extra": extra, "arrays": {}}
        np.savez(tmp / "arrays.npz", **flat)
        for k, v in flat.items():
            manifest["arrays"][k] = {
                "shape": list(v.shape),
                "dtype": str(v.dtype),
                "checksum": _checksum(v),
            }
        with open(tmp / "MANIFEST.json", "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        final = self._step_dir(step)
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # ------------------------------------------------------------------
    def save(self, step: int, tree: Any, extra: Optional[Dict] = None, blocking: bool = True,
             shardings: Any = None):
        """Snapshot ``tree`` (device -> host) and persist it. With
        ``shardings`` (a tree of ``NamedSharding`` shaped like ``tree``; see
        :func:`_shardings`) every rank of the mesh must call it: the leaves
        are gathered whole, and rank 0 writes them; a blocking save ends with
        a barrier, so every rank sees the checkpoint once it returns."""
        self.wait()  # one in-flight async save at a time
        if shardings is None:
            flat = _flatten(tree)  # the host copy happens here
        else:
            flat = {}
            for key, leaf in _gathered(tree, shardings).items():
                suffix, arr = _to_numpy(leaf)
                flat[key + suffix] = arr
        if _is_writer(shardings):
            if blocking:
                self._write(step, flat, extra or {})
            else:
                self._thread = threading.Thread(
                    target=self._write, args=(step, flat, extra or {}), daemon=True
                )
                self._thread.start()
        if shardings is not None and blocking and dist.is_available() and dist.is_initialized():
            dist.barrier()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    # ------------------------------------------------------------------
    def restore(self, like: Any, step: Optional[int] = None,
                shardings: Any = None) -> Tuple[Any, Dict]:
        """Restore into the structure of ``like``: each tensor leaf comes back
        on ``like``'s device in its dtype, a module's parameters and buffers
        are loaded in place (the module itself is returned). With
        ``shardings`` (see :meth:`save`) the stored full arrays are placed
        under the current mesh: each rank takes its block of each sharded
        leaf (an elastic restart: the mesh may differ from the one that
        saved). A corrupt checkpoint falls back to the previous step."""
        self.wait()
        candidates = self.all_steps() if step is None else [step]
        last_err: Optional[Exception] = None
        for s in reversed(candidates):
            try:
                return self._restore_step(s, like, shardings)
            except Exception as e:  # corrupted -> try the previous one
                last_err = e
                continue
        raise FileNotFoundError(f"no restorable checkpoint in {self.dir}: {last_err}")

    def _restore_step(self, step: int, like: Any, shardings: Any = None) -> Tuple[Any, Dict]:
        from ..distributed.collectives import comm_for
        from ..distributed.sharding import local_block

        by_path = _shardings(shardings)
        d = self._step_dir(step)
        manifest = json.loads((d / "MANIFEST.json").read_text())
        data = np.load(d / "arrays.npz")
        arrays = {}  # every leaf read and verified before any is placed
        for key, leaf in _leaves(like):
            stored = key + "::bf16" if key + "::bf16" in data else key
            arr = data[stored]
            if _checksum(arr) != manifest["arrays"][stored]["checksum"]:
                raise IOError(f"checksum mismatch for {key} at step {step}")
            if stored.endswith("::bf16"):
                arr = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
            sh = by_path.get(key)
            if sh is not None:
                arr = local_block(torch.as_tensor(arr), sh.spec, comm_for(sh.mesh)).clone()
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"shape mismatch for {key}: {tuple(arr.shape)} vs {tuple(leaf.shape)}")
            arrays[key] = arr
        return _place(like, arrays, ""), manifest.get("extra", {})


def _place(like: Any, arrays: Dict[str, Any], prefix: str) -> Any:
    """``like`` rebuilt from ``arrays`` (keys as :func:`_leaves` names them)."""
    def key(k):
        return f"{prefix}/{k}" if prefix else str(k)

    if isinstance(like, nn.Module):
        with torch.no_grad():
            for name, t in like.state_dict(keep_vars=True).items():
                t.copy_(_as_tensor(arrays[key(name)], t))
        return like
    if isinstance(like, dict):
        return {k: _place(v, arrays, key(k)) for k, v in like.items()}
    if isinstance(like, tuple):
        items = [_place(v, arrays, key(part)) for part, v in zip(_parts(like), like)]
        return type(like)(*items) if hasattr(like, "_fields") else tuple(items)
    if like is None:
        return None
    if isinstance(like, torch.Tensor):
        return _as_tensor(arrays[prefix], like)
    return np.asarray(arrays[prefix])


def _as_tensor(arr, like: torch.Tensor) -> torch.Tensor:
    t = arr if isinstance(arr, torch.Tensor) else torch.from_numpy(np.array(arr))
    return t.to(device=like.device, dtype=like.dtype)
