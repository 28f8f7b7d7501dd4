"""Checkpoint store: atomic and resumable, the port of the JAX package's
``repro/checkpoint/store.py`` with its on-disk layout, so a checkpoint
written by either package restores in the other.

Layout: ``<dir>/step_<N:010d>/`` holds one ``.npy`` per leaf, named by
``pytree.leaf_names`` (the JAX package's ``keystr`` names), and
``manifest.json`` (step, tree structure, each leaf's name, shape and dtype,
the caller's metadata). A save writes into ``step_<N>.tmp``, syncs every
file to disk and then renames the directory into place, so a run killed
mid-save leaves the last complete step as the latest (``latest_step`` sees
only directories named ``step_<N>`` that hold a manifest).

**bfloat16 leaves** (Muon's ``mom``): NumPy has no bfloat16 without
``ml_dtypes``, which the port does not need. The port stores such a leaf as
its uint16 bit pattern, the manifest's dtype saying ``bfloat16``, and
restores it as ``torch.bfloat16`` from that or from the JAX package's own
file (which NumPy reads back as the 2-byte void type ``|V2``). The JAX
package's ``restore`` reads the port's file as a uint16 array holding the
bits (``jax.lax.bitcast_convert_type(x, jnp.bfloat16)`` makes it the leaf).

``reshard`` (a restore onto another mesh) has no counterpart yet: the
port has no model meshes.
"""
from __future__ import annotations

import json
import os
import re
import shutil

import numpy as np
import torch

from .. import pytree
from ..core.formats import resolve_device

BFLOAT16 = "bfloat16"


def _host_array(leaf) -> np.ndarray:
    """A leaf as a numpy array; a bfloat16 tensor as its uint16 bits."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.asarray(leaf)


def _dtype_name(leaf, arr: np.ndarray) -> str:
    if isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16:
        return BFLOAT16
    return str(arr.dtype)


def _fsynced_save(path: str, arr: np.ndarray) -> None:
    with open(path, "wb") as f:
        np.save(f, arr)
        f.flush()
        os.fsync(f.fileno())


def save(ckpt_dir: str, step: int, tree, *, metadata: dict | None = None,
         keep: int = 3) -> str:
    """Write ``tree`` as step ``step`` of ``ckpt_dir`` and keep the newest
    ``keep`` steps; returns the step's directory."""
    pairs, treedef = pytree.flatten_with_paths(tree)
    names = pytree.leaf_names(tree)
    final = os.path.join(ckpt_dir, f"step_{step:010d}")
    tmp = final + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "treedef": repr(treedef), "leaves": [],
                "metadata": metadata or {}}
    for name, (_, leaf) in zip(names, pairs):
        arr = _host_array(leaf)
        _fsynced_save(os.path.join(tmp, name + ".npy"), arr)
        manifest["leaves"].append({"name": name, "shape": list(arr.shape),
                                   "dtype": _dtype_name(leaf, arr)})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    shutil.rmtree(final, ignore_errors=True)
    os.rename(tmp, final)
    _gc(ckpt_dir, keep)
    return final


def _gc(ckpt_dir: str, keep: int) -> None:
    steps = sorted(_steps(ckpt_dir))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:010d}"),
                      ignore_errors=True)


def _steps(ckpt_dir: str) -> list:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for d in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d+)", d)
        if m and os.path.exists(os.path.join(ckpt_dir, d, "manifest.json")):
            out.append(int(m.group(1)))
    return out


def latest_step(ckpt_dir: str):
    steps = _steps(ckpt_dir)
    return max(steps) if steps else None


def _to_tensor(arr: np.ndarray, dtype: str, dev: torch.device) -> torch.Tensor:
    if dtype == BFLOAT16:
        bits = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16).to(dev)
    return torch.from_numpy(np.array(arr, copy=True)).to(dev)


def restore(ckpt_dir: str, step: int, like, *, device=None):
    """Restore step ``step`` into the structure of ``like`` (its leaves
    only name the files); returns ``(tree, metadata)``, every leaf a tensor
    on ``device`` (default: the card; raises when there is none) in the
    dtype the manifest names."""
    dev = resolve_device(device)
    path = os.path.join(ckpt_dir, f"step_{step:010d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    dtypes = {leaf["name"]: leaf["dtype"] for leaf in manifest["leaves"]}
    names = pytree.leaf_names(like)
    missing = [n for n in names if n not in dtypes]
    if missing:
        raise KeyError(f"step {step} of {ckpt_dir} holds no leaves {missing}")
    _, treedef = pytree.flatten(like)
    tensors = [_to_tensor(np.load(os.path.join(path, n + ".npy")), dtypes[n],
                          dev) for n in names]
    return pytree.unflatten(treedef, tensors), manifest["metadata"]
