"""State serialization (counterpart of `front_end_tpu/utils/checkpoint.py`).

The JAX package saves any carried state as a pytree of arrays.  The port's
states (`VOState`, `WindowVOState`, the tracker's `WindowState`,
`LandmarkStore`) are NamedTuples and dataclasses that hold, beside
tensors, three things a pytree of arrays does not: the host-side frame
indices (Python ints), `None` for the packed words of float descriptors,
and the RANSAC `torch.Generator`, whose state a resume must carry or the
draws after it differ.  `save_state` walks the structure and writes one
`.npz` under stable dotted keys, with a manifest of each leaf's kind;
`load_state` walks a template (a fresh `init_state(...)` of the same
configuration) and checks every leaf's kind, shape and dtype against the
file, so a configuration mismatch fails loudly instead of resuming
garbage.  Tensors load onto the template's device.  No pickle: the files
are plain numpy archives.
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

_MANIFEST = "_kinds"


def _npz_path(path: str) -> str:
    """np.savez appends '.npz' to extensionless paths; np.load does not.
    Normalize so `save_state(p)` and `load_state(p)` round-trip for any p."""
    return path if path.endswith(".npz") else path + ".npz"


def _children(node):
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return [(f, getattr(node, f)) for f in node._fields]
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [(f.name, getattr(node, f.name))
                for f in dataclasses.fields(node)]
    return None


def _leaves(node, prefix=""):
    """(dotted path, leaf) pairs in field order."""
    kids = _children(node)
    if kids is None:
        yield prefix, node
        return
    for name, child in kids:
        yield from _leaves(child, f"{prefix}.{name}" if prefix else name)


def _kind(leaf) -> str:
    if leaf is None:
        return "none"
    if isinstance(leaf, torch.Generator):
        return "generator"
    if isinstance(leaf, torch.Tensor):
        return "tensor"
    if isinstance(leaf, (bool, int)):
        return "int"
    raise TypeError(f"cannot checkpoint a {type(leaf).__name__}")


def save_state(path: str, state) -> int:
    """Write `state` to `path` (.npz).  Returns the number of leaves."""
    arrays, kinds = {}, {}
    for key, leaf in _leaves(state):
        kinds[key] = _kind(leaf)
        if kinds[key] == "generator":
            arrays[key] = leaf.get_state().numpy()
        elif kinds[key] == "tensor":
            arrays[key] = leaf.detach().cpu().numpy()
        elif kinds[key] == "int":
            arrays[key] = np.asarray(leaf, np.int64)
    arrays[_MANIFEST] = np.frombuffer(json.dumps(kinds).encode(), np.uint8)
    np.savez(_npz_path(path), **arrays)
    return len(kinds)


def _rebuild(node, values, prefix=""):
    kids = _children(node)
    if kids is None:
        return values[prefix]
    new = {name: _rebuild(child, values,
                          f"{prefix}.{name}" if prefix else name)
           for name, child in kids}
    if isinstance(node, tuple):
        return type(node)(**new)
    return dataclasses.replace(node, **new)


def load_state(path: str, template):
    """Read a `save_state` file back into `template`'s structure, every
    leaf checked against the template's kind, shape and dtype."""
    values = {}
    with np.load(_npz_path(path)) as z:
        kinds = json.loads(z[_MANIFEST].tobytes().decode())
        t_leaves = dict(_leaves(template))
        if list(kinds) != list(t_leaves):
            raise ValueError(
                f"checkpoint leaves {sorted(set(kinds) ^ set(t_leaves))} "
                "differ from the template's — config mismatch")
        for key, t in t_leaves.items():
            kind = _kind(t)
            if kinds[key] != kind:
                raise ValueError(
                    f"leaf {key}: checkpoint holds a {kinds[key]}, the "
                    f"template a {kind} — config mismatch")
            if kind == "none":
                values[key] = None
            elif kind == "int":
                values[key] = type(t)(z[key])
            elif kind == "generator":
                g = torch.Generator(t.device)
                g.set_state(torch.from_numpy(z[key].copy()))
                values[key] = g
            else:
                a = torch.from_numpy(z[key].copy())
                if tuple(a.shape) != tuple(t.shape):
                    raise ValueError(
                        f"leaf {key}: checkpoint shape {tuple(a.shape)} != "
                        f"template shape {tuple(t.shape)} — config mismatch")
                if a.dtype != t.dtype:
                    raise ValueError(
                        f"leaf {key}: checkpoint dtype {a.dtype} != "
                        f"template dtype {t.dtype} — config mismatch")
                values[key] = a.to(t.device)
    return _rebuild(template, values)
