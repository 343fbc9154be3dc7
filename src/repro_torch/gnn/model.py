"""GraphStorm model template: input encoder -> graph encoder -> decoder.

Parameters are nested dicts of tensors laid out as the reference
package's parameter pytree (``{"input": {nt: {"w", "b"}}, "layers":
[...]}``), so a checkpoint written by the reference maps onto them key
for key (``checkpoint.io.params_from_flat``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.gnn.layers import LAYERS
from repro_torch.gnn.schema import BlockSchema, ekey


@dataclasses.dataclass(frozen=True)
class GSgnnModel:
    kind: str            # layer zoo entry
    hidden: int
    num_layers: int
    ntypes: Tuple[str, ...] = ()
    etypes: Tuple[Tuple[str, str, str], ...] = ()  # (ekey, src_t, dst_t)
    feat_dims: Tuple[Tuple[str, int], ...] = ()    # per-ntype input dim


def init_gnn_model(model: GSgnnModel, generator: torch.Generator,
                   device: torch.device):
    """Random weights from ``generator`` (normal, scaled as in the
    reference; the values differ from its ``jax.random`` draws)."""
    if model.kind not in LAYERS:
        raise KeyError(f"unknown GNN {model.kind!r}; ported: "
                       f"{sorted(LAYERS)}")
    init_fn, _ = LAYERS[model.kind]
    inp = {}
    for nt, d in sorted(dict(model.feat_dims).items()):
        w = torch.randn((d, model.hidden), generator=generator) * d ** -0.5
        inp[nt] = {"w": w.to(device),
                   "b": torch.zeros(model.hidden, device=device)}
    d_in = {nt: model.hidden for nt in model.ntypes}
    layers = [init_fn(generator, list(model.ntypes), list(model.etypes),
                      d_in, model.hidden, device)
              for _ in range(model.num_layers)]
    return {"input": inp, "layers": layers}


def input_encode(params, feats: Dict[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
    out = {}
    for nt, x in feats.items():
        p = params["input"][nt]
        out[nt] = torch.relu(x @ p["w"] + p["b"])
    return out


def gnn_apply_blocks(params, model: GSgnnModel, schema: BlockSchema,
                     arrays) -> Dict[str, torch.Tensor]:
    """Run the GNN over an MFG mini-batch; returns seed embeddings."""
    _, apply_fn = LAYERS[model.kind]
    h = input_encode(params, arrays["feats"])
    for layer, lsch in enumerate(schema.layers):
        h = apply_fn(params["layers"][layer], lsch,
                     {"masks": arrays["masks"][layer]}, h)
        if layer < schema.num_layers - 1:
            h = {nt: torch.relu(v) for nt, v in h.items()}
    return h


def model_meta_from_graph(graph, kind: str, hidden: int, num_layers: int,
                          extra_feat_dims: Optional[Dict[str, int]] = None,
                          feat_field: str = "feat") -> GSgnnModel:
    feat_dims = {nt: graph.feat_dim(nt, feat_field) for nt in graph.ntypes
                 if graph.feat_dim(nt, feat_field)}
    if extra_feat_dims:
        feat_dims.update(extra_feat_dims)
    return GSgnnModel(
        kind=kind, hidden=hidden, num_layers=num_layers,
        ntypes=tuple(graph.ntypes),
        etypes=tuple((ekey(et), et[0], et[2]) for et in graph.etypes),
        feat_dims=tuple(sorted(feat_dims.items())),
    )
