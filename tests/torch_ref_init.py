"""The reference's weights drawn the same in every process.

The reference's `api.init_params` folds `hash(path)` into each param's
key, and Python salts string hashes per process (PYTHONHASHSEED), so each
process draws other weights from the same key.  `ref_init` is
`init_params` with `zlib.crc32` of the path in place of `hash`: the
reference's own `param_table` and `_init_leaf`, the same weights in every
process.  The port's parity tests draw the reference's weights through it
(they import jax; the port itself never does).
"""
from __future__ import annotations

import zlib

import jax

from repro.models import api as ref_api


def ref_init(cfg, key):
    """The reference's init of `cfg` from `key` (a jax PRNG key), each
    param's key folded with the crc32 of its path."""
    flat, treedef = jax.tree.flatten_with_path(ref_api.param_table(cfg),
                                               is_leaf=ref_api._is_spec)
    leaves = []
    for path, spec in flat:
        pstr = "/".join(str(p) for p in path)
        k = jax.random.fold_in(key, zlib.crc32(pstr.encode()) % (2 ** 31))
        leaves.append(ref_api._init_leaf(spec, k, cfg))
    return jax.tree.unflatten(treedef, leaves)
