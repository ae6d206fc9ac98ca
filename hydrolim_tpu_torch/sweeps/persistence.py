"""Config-hash-keyed persistence of sweep results.

A copy of the JAX package's ``sweeps/persistence.py`` (the package must
not import it): a sweep result dict is stored under a key derived from its
configuration, and :func:`cached_run` reloads instead of re-simulating
when an up-to-date file exists (the reference's ``run=False`` flag made
automatic).  ``config_hash`` is the JAX package's, so both packages give
the same hash for the same plain dict.

``save_pytree``/``load_pytree`` store a nested dict of arrays (numpy or
torch) in one npz under flattened key paths (``a/b/c``), in place of the
JAX package's orbax checkpoints; they need no package beyond numpy.
"""
from __future__ import annotations

import hashlib
import json
from pathlib import Path
from typing import Any, Callable, Dict, Optional

import numpy as np

_SEP = "/"


def config_hash(config: Dict[str, Any]) -> str:
    """Stable short hash of a JSON-serializable config dict (callables and
    arrays are reduced to reprs / lists)."""

    def norm(v):
        if callable(v):
            return getattr(v, "__name__", repr(type(v)))
        if isinstance(v, np.ndarray):
            return v.tolist()
        if isinstance(v, dict):
            return {k: norm(x) for k, x in sorted(v.items())}
        if isinstance(v, (list, tuple)):
            return [norm(x) for x in v]
        if isinstance(v, (np.floating, np.integer)):
            return v.item()
        return v

    blob = json.dumps(norm(config), sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def save_result(result: Dict[str, Any], path: str | Path,
                config: Optional[Dict] = None) -> None:
    """npz dump of a flat result dict (arrays/scalars; nested dicts are
    stored as pickled objects like the reference does for ps_kwargs)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    payload = {}
    for k, v in result.items():
        if isinstance(v, (dict, list)) and not isinstance(v, np.ndarray):
            payload[k] = np.asarray(v, dtype=object)
        else:
            payload[k] = np.asarray(v)
    if config is not None:
        payload["__config_hash__"] = np.asarray(config_hash(config))
    np.savez(path, **payload)


def load_result(path: str | Path) -> Dict[str, Any]:
    data = np.load(path, allow_pickle=True)
    out = {}
    for k in data.files:
        v = data[k]
        out[k] = v.item() if v.dtype == object and v.ndim == 0 else v
    return out


def cached_run(fn: Callable[[], Dict[str, Any]], *, config: Dict,
               cache_dir: str | Path = "hydrolim_cache",
               tag: str = "sweep", force: bool = False) -> Dict[str, Any]:
    """Run ``fn`` (an expensive sweep) unless a file with the same config
    hash exists; the reference's ``run=True/False`` flag made automatic."""
    cache_dir = Path(cache_dir)
    key = config_hash(config)
    path = cache_dir / f"{tag}_{key}.npz"
    if path.exists() and not force:
        out = load_result(path)
        if str(out.get("__config_hash__", "")) == key:
            return out
    result = fn()
    save_result(result, path, config=config)
    result["__config_hash__"] = key
    return result


def _flatten(tree, prefix: str, out: Dict[str, np.ndarray]) -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            if _SEP in str(k):
                raise ValueError(f"key {k!r} contains {_SEP!r}")
            _flatten(v, f"{prefix}{k}{_SEP}", out)
        return
    if hasattr(tree, "detach"):                 # a torch tensor
        tree = tree.detach().cpu().numpy()
    out[prefix[:-1]] = np.asarray(tree)


def save_pytree(tree: Dict[str, Any], path: str | Path) -> None:
    """A nested dict of arrays as one npz, keyed by the '/'-joined paths
    of its leaves; the file is replaced if it exists."""
    flat: Dict[str, np.ndarray] = {}
    _flatten(tree, "", flat)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as fh:
        np.savez(fh, **flat)


def load_pytree(path: str | Path) -> Dict[str, Any]:
    """The nested dict of numpy arrays that ``save_pytree`` stored."""
    tree: Dict[str, Any] = {}
    with np.load(Path(path)) as z:
        for key in z.files:
            *parents, leaf = key.split(_SEP)
            node = tree
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = z[key]
    return tree
