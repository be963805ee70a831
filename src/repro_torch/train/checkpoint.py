"""Checkpointing with atomic commit and elastic (re-meshed) restore, ported
from ``repro.train.checkpoint``.

Layout:  <dir>/step_<k>/
             manifest.json       leaf names, state paths, shapes, dtypes, step
             <leaf-id>.npy       one file per state leaf

Write protocol: serialize into ``step_<k>.tmp``, fsync, then atomically
``rename`` to ``step_<k>``: a crash mid-write never corrupts the latest
checkpoint (restore only ever sees fully committed directories, and
``find_latest`` skips a stray ``.tmp``).  The newest ``keep`` are kept.

numpy has no bfloat16, so a bf16 leaf is stored as its raw 16-bit
pattern (``int16``) and the manifest records ``bfloat16``; restore views
the bits back, so a restart is bitwise.

On a device mesh (DTensor leaves) every rank calls ``save``: each leaf is
gathered whole (``full_tensor``), rank 0 writes the same files as on one
device, and the ranks meet at a barrier after the commit.  The on-disk
format is unpartitioned, so ``restore`` places each leaf as the leaf of
``like`` it is read into is placed, as the reference's ``device_put``
places it by its target sharding: a checkpoint written on one mesh
restores onto another (an elastic shrink), onto one device, or from one
device onto a mesh.  The port's state holds the model's own parameters,
so the target layout is set on the model (``launch.train.shard_model``,
by ``launch.shardings.param_shardings``) before ``init_state`` and
``restore``; the moments follow their parameters.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.train.optimizer import AdamState


def _leaves(state) -> List[Tuple[str, object]]:
    """(path, leaf) of a ``TrainState`` in a fixed order: the step, the
    params, the optimizer's step, mu and nu (each by parameter name)."""
    out: List[Tuple[str, object]] = [("step", state.step)]
    out += [(f"params/{k}", v) for k, v in state.params.items()]
    out.append(("opt/step", state.opt.step))
    out += [(f"opt/mu/{k}", v) for k, v in state.opt.mu.items()]
    out += [(f"opt/nu/{k}", v) for k, v in state.opt.nu.items()]
    return out


def _on_mesh(state) -> bool:
    return any(isinstance(v, DTensor) for _, v in _leaves(state))


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    if isinstance(leaf, int):
        return np.asarray(leaf, dtype=np.int32), "int32"
    if isinstance(leaf, DTensor):
        leaf = leaf.full_tensor()
    t = leaf.detach().cpu()
    dtype = str(t.dtype).split(".")[-1]
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy(), dtype
    return t.numpy(), dtype


def _write(path: str, arr: np.ndarray) -> None:
    with open(path, "wb") as f:
        np.save(f, arr)
        f.flush()
        os.fsync(f.fileno())


def save(directory: str, state, step: Optional[int] = None,
         keep: int = 3) -> str:
    """Write ``state`` as ``<directory>/step_<step>`` and return its path.
    On a mesh every rank calls it and rank 0 writes."""
    step = state.step if step is None else int(step)
    final = os.path.join(directory, f"step_{step:08d}")
    # one leaf at a time: a gather (on a mesh) and a write, then the next
    arrays = ((path, _to_numpy(leaf)) for path, leaf in _leaves(state))
    if not _on_mesh(state):
        _commit(directory, final, step, arrays, keep)
        return final
    if dist.get_rank() == 0:
        _commit(directory, final, step, arrays, keep)
    else:
        for _ in arrays:       # take part in every leaf's gather
            pass
    dist.barrier()
    return final


def _commit(directory: str, final: str, step: int, arrays, keep: int
            ) -> None:
    """Write ``arrays`` ((path, (array, dtype)) pairs, made one by one) into
    ``final`` with atomic commit, and keep the newest ``keep``
    checkpoints."""
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)

    manifest = {"step": step, "leaves": []}
    for i, (path, (arr, dtype)) in enumerate(arrays):
        name = f"leaf_{i:05d}"
        _write(os.path.join(tmp, name + ".npy"), arr)
        manifest["leaves"].append({"name": name, "path": path,
                                   "shape": list(arr.shape), "dtype": dtype})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)               # atomic commit

    ckpts = sorted(d for d in os.listdir(directory)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for old in ckpts[:-keep]:
        shutil.rmtree(os.path.join(directory, old))


def find_latest(directory: str) -> Optional[str]:
    if not os.path.isdir(directory):
        return None
    ckpts = sorted(d for d in os.listdir(directory)
                   if d.startswith("step_") and not d.endswith(".tmp")
                   and os.path.exists(os.path.join(directory, d,
                                                   "manifest.json")))
    return os.path.join(directory, ckpts[-1]) if ckpts else None


@torch.no_grad()
def restore(path: str, like):
    """Load the checkpoint at ``path`` into the tensors of ``like`` (a
    ``TrainState`` of the same model: the model's parameters and the
    moments are overwritten in place) and return the restored state.  A
    DTensor leaf of ``like`` takes its shard of the whole array on every
    rank; a plain leaf takes the whole array."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    leaves = _leaves(like)
    if len(leaves) != len(manifest["leaves"]):
        raise ValueError(f"checkpoint has {len(manifest['leaves'])} leaves, "
                         f"expected {len(leaves)}")
    steps = {}
    for (path_, leaf), entry in zip(leaves, manifest["leaves"]):
        if entry["path"] != path_:
            raise ValueError(f"checkpoint leaf {entry['path']!r} where "
                             f"{path_!r} was expected")
        arr = np.load(os.path.join(path, entry["name"] + ".npy"))
        if isinstance(leaf, int):
            steps[path_] = int(arr)
            continue
        want = str(leaf.dtype).split(".")[-1]
        if entry["dtype"] != want or tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"{path_}: {entry['dtype']} {tuple(arr.shape)} "
                             f"in the checkpoint, {want} "
                             f"{tuple(leaf.shape)} expected")
        t = torch.from_numpy(arr)
        if leaf.dtype == torch.bfloat16:
            t = t.view(torch.bfloat16)
        if isinstance(leaf, DTensor):
            t = distribute_tensor(t.to(leaf.device), leaf.device_mesh,
                                  leaf.placements, src_data_rank=None)
        leaf.copy_(t)
    return type(like)(step=steps["step"], params=like.params,
                      opt=AdamState(steps["opt/step"], like.opt.mu,
                                    like.opt.nu))
