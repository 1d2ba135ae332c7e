"""Checkpoints with an async save, atomic re-saves and an elastic restore.

Mirrors ``repro.checkpoint.checkpointer``.  Layout:
``<dir>/step_<n>/manifest.json`` plus one ``.npy`` per leaf, keyed by its
path; the manifest records each leaf's global shape and dtype.  The
snapshot to host memory is synchronous, the write runs on a thread
(``wait()`` joins it), into ``step_<n>.tmp`` that ``os.replace`` then puts
in place, so saving the same step again (a replay after a fault) is
atomic; only the last ``keep`` steps stay.

The tree is a flat mapping of leaf paths to tensors, numpy arrays or
numbers (``repro_torch.train.loop.state_to_global`` makes one of a
``TrainState``, at global shapes whatever the mesh), so a restore onto any
group size needs no conversion step: each rank takes its own rows of the
global arrays (``state_from_global``).  numpy has no bfloat16: such a
leaf is stored as its uint16 bit pattern and its manifest dtype says
"bfloat16".

On a mesh (``group``) every rank holds the same global tree, rank 0 of the
group writes it, and ``wait()`` ends with a barrier, so after it every
rank sees the same steps on disk.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading

import numpy as np
import torch

from repro_torch.parallel import collectives

__all__ = ["Checkpointer", "to_host"]


def to_host(v) -> tuple[np.ndarray, str]:
    """A leaf as a host numpy array and its dtype's name."""
    if isinstance(v, torch.Tensor):
        t = v.detach().to("cpu")
        if t.dtype == torch.bfloat16:
            return t.view(torch.uint16).numpy().copy(), "bfloat16"
        a = t.numpy().copy()
        return a, str(a.dtype)
    a = np.array(v, copy=True)
    return a, str(a.dtype)


def _from_host(a: np.ndarray, dtype: str) -> np.ndarray | torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(a).view(torch.bfloat16)
    return a


class Checkpointer:
    def __init__(self, directory: str, *, keep: int = 3, group=None):
        self.directory = directory
        self.keep = keep
        self.group = group
        self._thread: threading.Thread | None = None
        os.makedirs(directory, exist_ok=True)

    @property
    def _writer(self) -> bool:
        return self.group is None or self.group.rank == 0

    # ---------------- save ----------------

    def save(self, step: int, tree: dict, *, blocking: bool = False):
        """Snapshot ``tree`` to host memory now; write it to disk on a
        thread (``blocking``: before returning)."""
        self.wait()
        if not self._writer:
            if blocking:
                self.wait()
            return
        host = {}
        for k, v in tree.items():
            if v is not None:
                host[k] = to_host(v)
        manifest = {"step": step,
                    "leaves": {k: {"shape": list(a.shape), "dtype": dt}
                               for k, (a, dt) in host.items()}}

        def _write():
            d = os.path.join(self.directory, f"step_{step:08d}")
            tmp = d + ".tmp"
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            for k, (a, _) in host.items():
                fn = re.sub(r"[^\w.\-]", "_", k) + ".npy"
                np.save(os.path.join(tmp, fn), a)
                manifest["leaves"][k]["file"] = fn
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            # Re-saving the same step (post-fault replay) must be atomic.
            shutil.rmtree(d, ignore_errors=True)
            os.replace(tmp, d)
            self._gc()

        if blocking:
            _write()
            self.wait()
        else:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()

    def wait(self):
        """Join the pending write; on a mesh, then a barrier."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.group is not None and self.group.size > 1:
            collectives.barrier(self.group)

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    # ---------------- restore ----------------

    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.directory):
            m = re.fullmatch(r"step_(\d+)", name)
            if m and os.path.exists(os.path.join(self.directory, name,
                                                 "manifest.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, shapes: dict | None = None, step: int | None = None):
        """``(tree, step)``: the stored leaves (numpy; bfloat16 ones as
        bfloat16 CPU tensors) of ``step`` (default: the latest).
        ``shapes``: the expected global shape of every leaf to load (a
        missing leaf or another shape raises); None loads every leaf."""
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        d = os.path.join(self.directory, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        keys = manifest["leaves"] if shapes is None else shapes
        out = {}
        for key in keys:
            ent = manifest["leaves"].get(key)
            if ent is None:
                raise KeyError(f"checkpoint {step} missing leaf {key}")
            if shapes is not None and \
                    list(ent["shape"]) != list(shapes[key]):
                raise ValueError(f"{key}: stored shape {ent['shape']} != "
                                 f"target {list(shapes[key])}")
            out[key] = _from_host(np.load(os.path.join(d, ent["file"])),
                                  ent["dtype"])
        return out, step
