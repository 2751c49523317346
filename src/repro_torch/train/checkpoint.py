"""Fault-tolerant checkpointing: atomic, hash-manifested, the reference's
on-disk layout.

  * ``step_XXXXXXXX/`` per saved step, written into a temporary directory
    and published by an atomic rename (a crashed writer never corrupts the
    latest checkpoint);
  * one ``.npy`` per leaf, named by the md5 of its tree path, and
    ``manifest.json`` with each file's sha256, shape and dtype, so a
    restart detects partial or corrupt files and falls back to the
    previous step;
  * retention of the last ``keep`` checkpoints.

Tree paths are those of ``jax.tree_util.tree_flatten_with_path`` in the
reference ("params/units/0/attn/wq", "opt/.step"), so either package
restores what the other saved.  Leaves are saved as numpy arrays and
restored onto the device and dtype of the template's leaves.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _flatten(tree, prefix: str = "") -> Dict[str, Any]:
    """{path: leaf} in the reference's leaf order and path spelling
    (dict keys sorted; list index; NamedTuple field as ".name"; None
    holds no leaf)."""
    def join(part):
        return f"{prefix}/{part}" if prefix else str(part)
    if tree is None:
        return {}
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flatten(tree[k], join(k)))
        return out
    if _is_namedtuple(tree):
        out = {}
        for f in tree._fields:
            out.update(_flatten(getattr(tree, f), join("." + f)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flatten(v, join(i)))
        return out
    return {prefix: tree}


def _unflatten(template, leaves: Dict[str, Any], prefix: str = ""):
    def join(part):
        return f"{prefix}/{part}" if prefix else str(part)
    if template is None:
        return None
    if isinstance(template, dict):
        return {k: _unflatten(v, leaves, join(k))
                for k, v in template.items()}
    if _is_namedtuple(template):
        return type(template)(*(_unflatten(getattr(template, f), leaves,
                                           join("." + f))
                                for f in template._fields))
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten(v, leaves, join(i))
                              for i, v in enumerate(template))
    return leaves[prefix]


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save(ckpt_dir: str, step: int, tree: Any, keep: int = 3) -> str:
    """Atomic checkpoint write. Returns the final directory path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = tempfile.mkdtemp(prefix=".tmp_ckpt_", dir=ckpt_dir)
    manifest = {"step": step, "arrays": {}}
    for key, leaf in _flatten(tree).items():
        arr = _to_numpy(leaf)
        fname = hashlib.md5(key.encode()).hexdigest() + ".npy"
        path = os.path.join(tmp, fname)
        np.save(path, arr)
        with open(path, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()
        manifest["arrays"][key] = {
            "file": fname, "sha256": digest,
            "shape": list(arr.shape), "dtype": str(arr.dtype)}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)          # atomic publish
    _gc(ckpt_dir, keep)
    return final


def _steps(ckpt_dir: str):
    return sorted({int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
                   if d.startswith("step_")})


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [s for s in _steps(ckpt_dir) if os.path.exists(
        os.path.join(ckpt_dir, f"step_{s:08d}", "manifest.json"))]
    return max(steps) if steps else None


class CorruptCheckpoint(IOError):
    """A checkpoint whose manifest or files do not verify."""


def restore(ckpt_dir: str, template: Any, step: Optional[int] = None
            ) -> Tuple[Any, int]:
    """Restore into the structure of ``template``; verify hashes; if the
    requested (default: newest) step is corrupt, fall back to the
    previous one.  Returns (tree, step)."""
    steps = sorted(_steps(ckpt_dir), reverse=True)
    if step is not None:
        steps = [s for s in steps if s <= step]
    last_err: Optional[Exception] = None
    for s in steps:
        try:
            return _restore_one(os.path.join(ckpt_dir, f"step_{s:08d}"),
                                template), s
        except (OSError, ValueError, KeyError, EOFError) as e:
            last_err = e           # corrupt or partial -> the previous one
    raise FileNotFoundError(
        f"no restorable checkpoint in {ckpt_dir}: {last_err}")


def _restore_one(path: str, template: Any):
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    leaves = {}
    for key, leaf in _flatten(template).items():
        meta = manifest["arrays"][key]
        fpath = os.path.join(path, meta["file"])
        with open(fpath, "rb") as f:
            raw = f.read()
        if hashlib.sha256(raw).hexdigest() != meta["sha256"]:
            raise CorruptCheckpoint(f"hash mismatch for {key} in {path}")
        arr = np.load(fpath)
        if isinstance(leaf, torch.Tensor):
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"{key}: saved shape {arr.shape}, "
                                 f"template {tuple(leaf.shape)}")
            arr = torch.from_numpy(arr).to(device=leaf.device,
                                           dtype=leaf.dtype)
        leaves[key] = arr
    return _unflatten(template, leaves)


def _gc(ckpt_dir: str, keep: int):
    steps = _steps(ckpt_dir)
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)
