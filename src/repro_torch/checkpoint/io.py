"""Reading checkpoints written by the reference package's
``save_trainer``.

A checkpoint directory holds ``params.npz`` (one array per parameter
leaf, keyed by its ``/``-joined tree path, e.g.
``gnn/layers/0/w_rel/author___writes___paper``), ``emb_<ntype>.npz``
(``table`` and ``gsum`` of each featureless ntype's embedding),
``meta.json`` (which ntypes have embeddings) and ``config.json`` (the
resolved run config).  Only numpy reads them, so no framework is needed
to load one.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict

import numpy as np
import torch


def load_flat(path: str) -> Dict[str, np.ndarray]:
    """The ``{path: array}`` dict of one ``.npz`` file."""
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def params_from_flat(flat: Dict[str, np.ndarray], device) -> dict:
    """Carry parameters across: ``/``-joined path keys -> the port's
    nested parameter dicts of tensors on ``device``.  A node whose keys
    are all integers is a list (the reference's list of layers)."""
    root: dict = {}
    for key, arr in flat.items():
        *parents, leaf = key.split("/")
        node = root
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = torch.from_numpy(np.array(arr)).to(device)
    return _lists_of(root)


def _lists_of(node):
    if not isinstance(node, dict):
        return node
    node = {k: _lists_of(v) for k, v in node.items()}
    if node and all(k.isdigit() for k in node):
        if sorted(int(k) for k in node) != list(range(len(node))):
            raise ValueError(f"list indices {sorted(node)} are not "
                             f"0..{len(node) - 1}")
        return [node[str(i)] for i in range(len(node))]
    return node


def flatten_params(params, prefix: str = "") -> Dict[str, torch.Tensor]:
    """The inverse of ``params_from_flat`` (path keys -> tensors)."""
    if isinstance(params, torch.Tensor):
        return {prefix: params}
    items = (params.items() if isinstance(params, dict)
             else enumerate(params))
    out: Dict[str, torch.Tensor] = {}
    for k, v in items:
        out.update(flatten_params(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def load_trainer(trainer, path: str):
    """Restore ``trainer.params`` and its embedding tables from a
    checkpoint directory.  The checkpoint must hold exactly the
    parameters the trainer's model has, at the same shapes."""
    flat = load_flat(os.path.join(path, "params.npz"))
    have = {k: tuple(v.shape) for k, v in flatten_params(trainer.params).items()}
    got = {k: tuple(v.shape) for k, v in flat.items()}
    if have != got:
        diff = sorted(set(have.items()) ^ set(got.items()))[:10]
        raise ValueError(f"checkpoint {path!r} does not match the model's "
                         f"parameters (first differences: {diff})")
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    for nt in meta.get("sparse", []):
        trainer.sparse_embeds[nt].load_state_dict(
            load_flat(os.path.join(path, f"emb_{nt}.npz")))
    # last, so the params version moves after the tables have changed too
    trainer.params = params_from_flat(flat, trainer.device)
    return trainer


def load_run_config(path: str) -> Dict[str, Any]:
    """Read the resolved config persisted next to a checkpoint."""
    with open(os.path.join(path, "config.json")) as f:
        return json.load(f)
