"""Fault-tolerant checkpointing: atomic, asynchronous, integrity-checked.
The port of ``src/repro/ckpt/manager.py``, in its own format.

Checkpoints store *logical* arrays: every leaf of a tree (nested dicts,
tuples and named tuples of tensors, as the parameters and the optimizer
state are) as a host numpy array, in the tree's flattening order.  Restore
puts them back into the structure of a template tree, on the template
leaves' devices and in their dtypes.

Format: one directory per step::

    ckpt_dir/step_000120/
        manifest.json   # step, leaf count, shapes, dtypes, sha256 per leaf, extra
        leaf_0.npy ...  # one numpy file per leaf (bf16 leaves stored as float32)
    ckpt_dir/LATEST     # atomic pointer file

Writes go to ``step_X.tmp-<pid>`` and then ``os.rename`` (atomic on POSIX),
and ``LATEST`` moves only after a whole write, so a crash mid-write never
corrupts an earlier checkpoint.  :meth:`CheckpointManager.save_async`
copies to the host now and writes on a background thread.

Under a sharding recipe every rank holds its shards: ``save(..., recipe=,
specs=)`` gathers each leaf that ``specs`` (a tree of
:class:`~repro_torch.models.module.ParamSpec` over part of the tree, e.g.
``{"params": lm.build_specs(cfg)}``) declares into its logical whole
(``weights.gather_params``, collective over the mesh), and rank 0 writes.
``restore(..., recipe=, specs=)`` cuts each such leaf by the *current*
recipe, so a checkpoint written under one mesh restores under another
world size (the reference's elastic reshard).
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from typing import Any

import numpy as np
import torch

__all__ = ["CheckpointManager", "flatten", "unflatten"]


def flatten(tree) -> list:
    """The leaves of ``tree``: dicts in sorted key order, tuples and lists
    (named tuples too) in order; anything else is a leaf."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in flatten(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for t in tree for leaf in flatten(t)]
    return [tree]


def unflatten(template, leaves):
    """A tree shaped like ``template`` with ``leaves`` in :func:`flatten`
    order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*(build(x) for x in t))
        if isinstance(t, (tuple, list)):
            return type(t)(build(x) for x in t)
        return next(it)

    return build(template)


def _to_host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:  # numpy has no bfloat16: exact in float32
            t = t.float()
        return t.cpu().numpy().copy()
    return np.asarray(leaf).copy()


def _cut(x, spec, recipe):
    """This rank's block of the logical leaf ``x`` under ``recipe``."""
    from repro_torch.models.sharding import recipe_pspecs
    from repro_torch.models.weights import shard_params

    return shard_params(x, recipe_pspecs(recipe, spec), recipe.mesh)


def _digest(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def _specs_in_order(tree, specs) -> list:
    """Each leaf's spec (a ``ParamSpec``, or ``None`` for a leaf no spec
    declares), in :func:`flatten` order."""
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in _specs_in_order(
            tree[k], specs.get(k) if isinstance(specs, dict) else None)]
    if isinstance(tree, (tuple, list)):
        subs = specs if isinstance(specs, (tuple, list)) else [None] * len(tree)
        return [s for t, sp in zip(tree, subs) for s in _specs_in_order(t, sp)]
    return [specs]


def _whole_leaves(tree, recipe, specs) -> list:
    """``tree``'s leaves, each declared one gathered into its logical whole
    under ``recipe`` (collective: every rank of the mesh calls it)."""
    from repro_torch.models.weights import gather_params

    return [gather_params(leaf, spec, recipe) if spec is not None else leaf
            for leaf, spec in zip(flatten(tree), _specs_in_order(tree, specs))]


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    # ------------------------------------------------------------- save ----
    def _host(self, tree, recipe, specs):
        """The host copies of ``tree``'s logical leaves, or ``None`` on a
        rank that does not write (under a recipe, all but rank 0)."""
        if recipe is None:
            return [_to_host(leaf) for leaf in flatten(tree)]
        leaves = _whole_leaves(tree, recipe, specs)
        return [_to_host(leaf) for leaf in leaves] if recipe.mesh.rank == 0 else None

    def save(self, step: int, tree: Any, *, extra: dict | None = None, recipe=None,
             specs=None) -> str | None:
        """Write ``tree`` as checkpoint ``step`` now; returns its directory
        (``None`` on a rank that does not write).  Under ``recipe`` the
        leaves that ``specs`` declares are this rank's shards (see the
        module docstring)."""
        host = self._host(tree, recipe, specs)
        return None if host is None else self._write(step, host, extra or {})

    def save_async(self, step: int, tree: Any, *, extra: dict | None = None, recipe=None,
                   specs=None) -> None:
        """Copy ``tree`` to the host now (gathering shards under
        ``recipe``); write it on a background thread."""
        self.wait()
        host = self._host(tree, recipe, specs)
        if host is None:
            return

        def work():
            try:
                self._write(step, host, extra or {})
            except BaseException as e:  # handed to the caller by wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Block until the background write (if any) ends; re-raise its error."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _write(self, step: int, host_leaves, extra: dict) -> str:
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = f"{final}.tmp-{os.getpid()}"
        os.makedirs(tmp, exist_ok=True)
        for i, a in enumerate(host_leaves):
            np.save(os.path.join(tmp, f"leaf_{i}.npy"), a, allow_pickle=False)
        manifest = {
            "step": step,
            "n_leaves": len(host_leaves),
            "leaves": [{"shape": list(a.shape), "dtype": str(a.dtype), "sha256": _digest(a)}
                       for a in host_leaves],
            "extra": extra,
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic
        self._update_latest(step)
        self._rotate()
        return final

    def _update_latest(self, step: int) -> None:
        tmp = os.path.join(self.dir, f".LATEST.tmp-{os.getpid()}")
        with open(tmp, "w") as f:
            f.write(str(step))
        os.rename(tmp, os.path.join(self.dir, "LATEST"))

    def _rotate(self) -> None:
        for s in self.all_steps()[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"), ignore_errors=True)

    # ---------------------------------------------------------- restore ----
    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and ".tmp" not in name:
                try:
                    out.append(int(name.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> int | None:
        path = os.path.join(self.dir, "LATEST")
        if os.path.exists(path):
            try:
                with open(path) as f:
                    step = int(f.read().strip())
                if os.path.isdir(os.path.join(self.dir, f"step_{step:08d}")):
                    return step
            except ValueError:
                pass
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template: Any, step: int | None = None, *, verify: bool = True,
                recipe=None, specs=None) -> tuple[Any, dict]:
        """Restore checkpoint ``step`` (default: the latest) into the
        structure of ``template``: every tensor leaf on the template leaf's
        device in its dtype; under ``recipe`` each leaf that ``specs``
        declares cut to this rank's shard by the recipe's bindings, whatever
        mesh wrote it.  Returns ``(tree, extra)``; raises ``IOError`` when a
        leaf's hash does not match its manifest."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        host = [np.load(os.path.join(path, f"leaf_{i}.npy"), allow_pickle=False)
                for i in range(manifest["n_leaves"])]
        if verify:
            for a, meta in zip(host, manifest["leaves"]):
                if _digest(a) != meta["sha256"]:
                    raise IOError(f"checkpoint corruption at step {step}: leaf hash mismatch")
        like = flatten(template)
        if len(like) != len(host):
            raise ValueError(f"checkpoint has {len(host)} leaves, template needs {len(like)}")
        leaf_specs = _specs_in_order(template, specs) if recipe is not None else \
            [None] * len(like)
        placed = []
        for a, t, spec in zip(host, like, leaf_specs):
            if not isinstance(t, torch.Tensor):
                placed.append(a)
                continue
            x = torch.from_numpy(a).to(device=t.device, dtype=t.dtype)
            if spec is not None:
                x = _cut(x, spec, recipe)
            if x.shape != t.shape:
                raise ValueError(f"checkpoint leaf of shape {tuple(x.shape)} does not fit the "
                                 f"template's {tuple(t.shape)}")
            placed.append(x)
        return unflatten(template, placed), manifest.get("extra", {})
