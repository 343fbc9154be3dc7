"""GNN layers over padded MFG blocks (the port covers RGCN so far).

A layer is a pair of plain functions over a parameter dict:

    init(generator, ntypes, etypes, d_in: {nt: int}, d_out, device)
        -> params
    apply(params, lsch: LayerSchema, arrays_l, src_h) -> {nt: (n_dst, d_out)}

where ``src_h`` maps ntype -> (src_count, d) hidden rows of the input
frontier and ``arrays_l`` carries the layer's masks.
"""
from __future__ import annotations

import torch

from repro_torch.gnn.aggregate import fanout_indices, gather_masked_agg
from repro_torch.gnn.schema import LayerSchema


def _agg_fanout(src_h, em, mask, reduce: str):
    """Aggregate an edge block's fanout rows with the fused kernel."""
    h = src_h[em.src_t]
    idx = fanout_indices(em.src_offset, em.num_dst, em.fanout, h.device)
    return gather_masked_agg(h, idx, mask, reduce)


def _self_rows(src_h, lsch: LayerSchema, nt: str):
    off = lsch.self_offset(nt)
    return src_h[nt][off:off + lsch.dst_count(nt)]


def _glorot(generator, shape, device):
    s = (2.0 / (shape[0] + shape[-1])) ** 0.5
    w = torch.randn(shape, generator=generator, dtype=torch.float32) * s
    return w.to(device)


# ---------------------------------------------------------------------------
# RGCN
# ---------------------------------------------------------------------------
def rgcn_init(generator, ntypes, etypes, d_in, d_out, device):
    """etypes: (ekey, src_t, dst_t) triples."""
    return {
        "w_rel": {ek: _glorot(generator, (d_in[st], d_out), device)
                  for ek, st, _ in etypes},
        "w_self": {nt: _glorot(generator, (d_in[nt], d_out), device)
                   for nt in ntypes},
        "b": {nt: torch.zeros(d_out, device=device) for nt in ntypes},
    }


def rgcn_apply(params, lsch: LayerSchema, arrays_l, src_h):
    out = {}
    for em in lsch.edges:
        agg = _agg_fanout(src_h, em, arrays_l["masks"][em.ekey], "mean")
        msg = agg @ params["w_rel"][em.ekey]
        out[em.dst_t] = out[em.dst_t] + msg if em.dst_t in out else msg
    res = {}
    for nt in dict(lsch.dst_counts):
        v = _self_rows(src_h, lsch, nt) @ params["w_self"][nt]
        res[nt] = (out[nt] + v if nt in out else v) + params["b"][nt]
    return res


LAYERS = {"rgcn": (rgcn_init, rgcn_apply)}
