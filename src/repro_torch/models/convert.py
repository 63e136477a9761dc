"""Move a reference config and param tree into the port.

The parity tests build params once, as numpy, and hand the same arrays to
both packages; the reference's own trees come across as
`jax.tree.map(np.asarray, params)`.  Nothing here imports jax: the input is
plain dicts of numpy arrays and plain config fields.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import api

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _dtype(x) -> torch.dtype:
    """A torch dtype from a torch dtype, a dtype name or anything numpy can
    name (jnp.float32, ml_dtypes' bfloat16, ...)."""
    if isinstance(x, torch.dtype):
        return x
    name = x if isinstance(x, str) else np.dtype(x).name
    return _DTYPES[name]


def config_from_fields(fields: dict) -> api.ModelConfig:
    """The port's ModelConfig from a reference ModelConfig's fields
    (`dataclasses.asdict(cfg)`); dtypes may be given by name."""
    f = dict(fields)
    for k in ("param_dtype", "compute_dtype", "kv_dtype"):
        f[k] = _dtype(f[k])
    if f.get("moe") is not None:
        f["moe"] = api.MoEConfig(**f["moe"])
    if f.get("ssm") is not None:
        f["ssm"] = api.SSMConfig(**f["ssm"])
    return api.ModelConfig(**f)


def _tensor(arr: np.ndarray, device) -> torch.Tensor:
    arr = np.ascontiguousarray(arr)
    if arr.dtype.name == "bfloat16":      # ml_dtypes: torch has no bridge
        return torch.from_numpy(arr.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def params_from_numpy(tree: dict, cfg: api.ModelConfig, device) -> dict:
    """The port's params on `device` from a nested dict of numpy arrays.

    The stacked leading `groups` axis of the block params is kept.  Paths
    and shapes are checked against the port's param table, so a tree that
    does not belong to `cfg` raises instead of loading.
    """
    want = dict(api.flatten(api.param_table(cfg)))
    got = dict(api.flatten(tree))
    if set(want) != set(got):
        raise ValueError(f"param paths differ: missing "
                         f"{sorted(set(want) - set(got))}, unexpected "
                         f"{sorted(set(got) - set(want))}")
    out = []
    for path, spec in want.items():
        arr = np.asarray(got[path])
        if tuple(arr.shape) != spec.shape:
            raise ValueError(f"{path}: shape {arr.shape} != {spec.shape}")
        out.append((path, _tensor(arr, device)))
    return api.unflatten(out)
