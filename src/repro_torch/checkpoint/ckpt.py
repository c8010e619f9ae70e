"""Checkpoints of trees of tensors with a manifest, async writes and a
retention policy (the JAX package's ``checkpoint/ckpt.py``).

Layout: ``<dir>/step_<N>/manifest.json`` plus one ``.npy`` a leaf, the JAX
package's leaf for leaf: a leaf's file is named by its path in pytree order
(``tree.flatten_with_path``: dict keys sorted, NamedTuple fields as
``.field``, joined by ``~``), bf16 leaves are stored as float32 under the
logical dtype ``"bfloat16"``, and the manifest holds the same ``step``,
``leaves`` and ``extra``. So each package loads the other's checkpoints. The
manifest's ``treedef`` is a description of the tree's structure, which no
load path reads (the JAX package writes its own pytree repr there).

Fault-tolerance contract (``runtime/fault.py``): a checkpoint directory is
committed only when ``manifest.json`` exists (written last, then the
directory renamed into place with one ``os.replace``), so a crash mid-write
never leaves a loadable but corrupt checkpoint.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree as tr
from repro_torch.device import DeviceLike, resolve_device

#: numpy's names of the dtypes a leaf may have, as the manifest writes them
_DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
                torch.float16: "float16", torch.float64: "float64",
                torch.int32: "int32", torch.int64: "int64",
                torch.int8: "int8", torch.uint8: "uint8",
                torch.bool: "bool"}


def _flatten(tree) -> List[Tuple[str, Any]]:
    out = []
    for path, leaf in tr.flatten_with_path(tree):
        name = "~".join(re.sub(r"[^\w\.\-]", "_", p) for p in path)
        out.append((name or "leaf", leaf))
    return out


class _MeshWrite:
    """The handle of a sharded state's save: ``join()`` waits for the first
    rank's write (a thread, or nothing) and then for every rank of the mesh
    (a barrier), so that the checkpoint is committed on return."""

    def __init__(self, thread: Optional[threading.Thread], mesh):
        self.thread, self.mesh = thread, mesh

    def join(self) -> None:
        if self.thread is not None:
            self.thread.join()
        from repro_torch.launch import mesh as mesh_lib
        mesh_lib.barrier(self.mesh)


def save_checkpoint(directory, step: int, tree, extra: Optional[Dict] = None,
                    async_write: bool = False, keep_last: int = 3,
                    shardings=None):
    """Write ``tree`` under <directory>/step_<step>. Returns a join() handle
    when ``async_write`` (the device->host copy happens now; the disk IO in a
    background thread — the standard async-checkpoint split).

    ``shardings``: a matching tree of ``launch.sharding.NamedSharding`` on a
    live mesh, ``tree``'s leaves this rank's shards. The files are still
    the JAX package's, one global array a leaf: each leaf is gathered whole
    onto the mesh's first rank (``sharding.gather_to_writer``), which alone
    writes, while the others wait at a barrier until the checkpoint is
    committed (with ``async_write``, at the handle's ``join()``, which
    every rank must call)."""
    directory = Path(directory)
    tmp = directory / f".tmp_step_{step}"
    final = directory / f"step_{step}"
    named = _flatten(tree)
    mesh = None
    if shardings is not None:
        from repro_torch.launch import mesh as mesh_lib
        from repro_torch.launch import sharding as shd
        shards = tr.leaves(shardings)
        mesh = shards[0].mesh
        # one leaf at a time: its whole copy is dropped before the next
        host_leaves = []
        for (n, x), sh in zip(named, shards):
            whole = shd.gather_to_writer(x.detach(), sh, mesh)
            if whole is not None:
                host_leaves.append((n, whole.cpu()))
            del whole
        if not mesh_lib.is_writer(mesh):
            handle = _MeshWrite(None, mesh)
            if async_write:
                return handle
            handle.join()
            return None
    else:
        host_leaves = [(n, x.detach().cpu()) for n, x in named]
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    treedef = tr.describe(tree)

    def _write():
        names = []
        for name, t in host_leaves:
            logical = _DTYPE_NAMES[t.dtype]
            if t.dtype == torch.bfloat16:
                # numpy has no bfloat16: store float32 (a lossless superset
                # of bf16); restore casts back via the template
                t = t.float()
            arr = t.numpy()
            np.save(tmp / f"{name}.npy", arr)
            names.append({"name": name, "shape": list(arr.shape),
                          "dtype": logical})
        manifest = {"step": step, "leaves": names,
                    "treedef": f"repro_torch {treedef}",
                    "extra": extra or {}}
        with open(tmp / "manifest.json", "w") as f:
            json.dump(manifest, f)
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)          # atomic commit
        _cleanup(directory, keep_last)

    if async_write:
        t = threading.Thread(target=_write, daemon=True)
        t.start()
        return t if mesh is None else _MeshWrite(t, mesh)
    _write()
    if mesh is not None:
        _MeshWrite(None, mesh).join()
    return None


def _cleanup(directory: Path, keep_last: int):
    steps = sorted(list_steps(directory))
    for s in steps[:-keep_last]:
        shutil.rmtree(Path(directory) / f"step_{s}", ignore_errors=True)


def list_steps(directory) -> List[int]:
    directory = Path(directory)
    if not directory.exists():
        return []
    out = []
    for d in directory.iterdir():
        m = re.fullmatch(r"step_(\d+)", d.name)
        if m and (d / "manifest.json").exists():
            out.append(int(m.group(1)))
    return sorted(out)


def _restore(arr: np.ndarray, like, device: torch.device) -> torch.Tensor:
    """A stored array as the template leaf's dtype, on its device: a tensor
    leaf's, or ``device`` for a (shape, dtype) leaf."""
    if isinstance(like, torch.Tensor):
        shape, dtype, device = tuple(like.shape), like.dtype, like.device
    else:
        shape, dtype = like
    if tuple(arr.shape) != tuple(shape):
        raise ValueError(f"checkpoint leaf of shape {arr.shape}, the "
                         f"template's is {tuple(shape)}")
    return torch.from_numpy(np.asarray(arr, order="C")).to(
        device=device, dtype=dtype)


def _mesh_device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _restore_shard(path: Path, like, sharding):
    """This rank's shard of a stored leaf as a DTensor on ``sharding``'s
    mesh: the file memory-mapped, only the shard's slice read."""
    from torch.distributed.tensor import DTensor
    shape, dtype = ((tuple(like.shape), like.dtype)
                    if not isinstance(like, tuple) else like)
    arr = np.load(path, mmap_mode="r")
    if tuple(arr.shape) != tuple(shape):
        raise ValueError(f"checkpoint leaf of shape {arr.shape}, the "
                         f"template's is {tuple(shape)}")
    local = np.array(arr[sharding.local_index(shape)], order="C")
    t = torch.from_numpy(local).to(device=_mesh_device(sharding.mesh),
                                   dtype=dtype)
    return DTensor.from_local(t, sharding.mesh, sharding.placements(),
                              run_check=False, shape=torch.Size(shape),
                              stride=torch.empty(shape,
                                                 device="meta").stride())


def load_checkpoint(directory, template, step: Optional[int] = None,
                    shardings=None, device: DeviceLike = None):
    """Restore into the structure of ``template`` (a tree of tensors, or of
    (shape, dtype) leaves), each leaf onto its template leaf's device and
    dtype: a template on the card restores onto the card. A (shape, dtype)
    leaf goes onto ``device``, which follows the port's device rule
    (``None`` is the card, and raises without one; ``"cpu"`` by name).
    Returns (step, tree, extra).

    ``shardings``: a matching tree of ``launch.sharding.NamedSharding`` on a
    live mesh. This is the *elastic* path: each rank reads only its shard
    of each stored leaf and gets it as a DTensor on that mesh (its local
    tensor on the mesh's device, the template's dtype), whatever mesh wrote
    the checkpoint; the files are the same either way."""
    directory = Path(directory)
    steps = list_steps(directory)
    if not steps:
        raise FileNotFoundError(f"no committed checkpoints under {directory}")
    step = steps[-1] if step is None else step
    d = directory / f"step_{step}"
    manifest = json.loads((d / "manifest.json").read_text())

    names = [l["name"] for l in manifest["leaves"]]
    flat_t = _flatten(template)
    assert [n for n, _ in flat_t] == names, (
        "checkpoint/template structure mismatch")
    if shardings is not None:
        shards = tr.leaves(shardings)
        if len(shards) != len(flat_t):
            raise ValueError("shardings and template differ in structure")
        restored = iter([_restore_shard(d / f"{n}.npy", like, sh)
                         for (n, like), sh in zip(flat_t, shards)])
    else:
        if not all(isinstance(like, torch.Tensor) for _, like in flat_t):
            device = resolve_device(device)
        # one leaf at a time: its host copy is dropped before the next is
        # read
        restored = iter([_restore(np.load(d / f"{n}.npy"), like, device)
                         for n, like in flat_t])
    tree = tr.tree_map(lambda _leaf: next(restored), template)
    return step, tree, manifest.get("extra", {})
