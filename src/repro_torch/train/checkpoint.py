"""Checkpointing: save/restore with atomic manifests (port of
``repro.train.checkpoint``, the same on-disk format).

Fault-tolerance contract:
  * a checkpoint is only visible once its manifest is atomically renamed
    into place (no torn checkpoints after a crash);
  * saves can run asynchronously (the trees are first copied to host
    memory, so training can go on mutating or reusing its buffers);
  * restore loads host-side and places every leaf on the ``device`` asked
    for, or on its template leaf's device;
  * the data pipeline is deterministic in (seed, step), so restoring
    (params, opt_state, step) fully determines the continuation.

Format: one .npz per tree (``params``, ``opt_state``) keyed by the
``/``-joined dict path of each leaf, and a JSON manifest carrying the step
and metadata.  numpy has no bfloat16, so a bfloat16 leaf is stored as its
``uint16`` view beside a ``__dtype__/<key>`` entry naming the dtype, as the
reference stores it: a checkpoint written by either package restores in
the other.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

#: dtypes numpy cannot hold: the same-width integer view each is stored
#: as (numpy's, and torch's for the bit cast), and its name in the file
_EXOTIC = {torch.bfloat16: (np.uint16, torch.int16, "bfloat16"),
           torch.float8_e4m3fn: (np.uint8, torch.uint8, "float8_e4m3fn"),
           torch.float8_e5m2: (np.uint8, torch.uint8, "float8_e5m2")}
_BY_NAME = {name: (dt, view) for dt, (_, view, name) in _EXOTIC.items()}


def _items(tree: Any, prefix: str = ""):
    """(key, leaf) in sorted-key order, keys ``/``-joined dict paths."""
    for k in sorted(tree):
        v = tree[k]
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            yield from _items(v, key + "/")
        else:
            yield key, v


def _flatten(tree: Any) -> Dict[str, np.ndarray]:
    flat = {}
    for key, leaf in _items(tree):
        t = leaf.detach().to("cpu", copy=True)          # a host snapshot
        if t.dtype in _EXOTIC:
            np_view, view, name = _EXOTIC[t.dtype]
            flat[key] = t.view(view).numpy().view(np_view)
            flat[f"__dtype__/{key}"] = np.asarray(name)
        else:
            flat[key] = t.numpy()
    return flat


def _leaf_from(flat: Dict[str, np.ndarray], key: str,
               template: torch.Tensor) -> torch.Tensor:
    if key not in flat:
        raise KeyError(f"checkpoint missing {key}")
    arr = flat[key]
    if tuple(arr.shape) != tuple(template.shape):
        raise ValueError(
            f"{key}: checkpoint shape {arr.shape} != {tuple(template.shape)}")
    t = torch.from_numpy(arr.copy(order="C"))
    dt_key = f"__dtype__/{key}"
    if dt_key in flat:
        dtype, view = _BY_NAME[str(flat[dt_key])]
        t = t.view(view).view(dtype)
    return t


def _unflatten_like(template: Any, flat: Dict[str, np.ndarray], device,
                    prefix: str = "") -> Any:
    out = {}
    for k in template:
        v = template[k]
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out[k] = _unflatten_like(v, flat, device, key + "/")
        else:
            out[k] = _leaf_from(flat, key, v).to(
                device if device is not None else v.device)
    return out


def save_checkpoint(ckpt_dir: str, step: int, trees: Dict[str, Any],
                    metadata: Optional[dict] = None,
                    async_save: bool = False) -> threading.Thread | None:
    """Write ``trees`` under ckpt_dir/step_<step>/ with an atomic
    manifest; with ``async_save`` the files are written by a thread, which
    is returned."""
    os.makedirs(ckpt_dir, exist_ok=True)
    # snapshot to host memory NOW (so training can mutate devices after)
    host = {name: _flatten(tree) for name, tree in trees.items()}

    def _write():
        final = os.path.join(ckpt_dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        for name, flat in host.items():
            np.savez(os.path.join(tmp, f"{name}.npz"), **flat)
        manifest = {"step": step, "trees": sorted(host),
                    "time": time.time(), **(metadata or {})}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic visibility

    if async_save:
        t = threading.Thread(target=_write, daemon=True)
        t.start()
        return t
    _write()
    return None


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for d in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d+)", d)
        if m and os.path.exists(os.path.join(ckpt_dir, d, "manifest.json")):
            steps.append(int(m.group(1)))
    return max(steps) if steps else None


def restore_checkpoint(ckpt_dir: str, templates: Dict[str, Any],
                       step: Optional[int] = None, device=None,
                       ) -> Tuple[Dict[str, Any], int]:
    """Restore trees shaped like ``templates``: each leaf on ``device``,
    or on its template leaf's device when ``device`` is None."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    out = {}
    for name, template in templates.items():
        with np.load(os.path.join(d, f"{name}.npz")) as z:
            flat = {k: z[k] for k in z.files}
        out[name] = _unflatten_like(template, flat, device)
    return out, step
