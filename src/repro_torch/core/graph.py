"""In-memory heterogeneous graph (the port's copy of ``repro.core.graph``).

Edges are stored per canonical edge type (src_ntype, relation, dst_ntype)
in COO and indexed as CSC (dst -> in-neighbors), because mini-batch GNN
sampling walks *incoming* edges of the seed nodes.  ``ntypes`` and
``etypes`` are sorted, which fixes the order every plan, schema and
parameter dict is built in.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

EType = Tuple[str, str, str]  # (src_ntype, relation, dst_ntype)


@dataclasses.dataclass
class CSC:
    """dst-indexed adjacency: in-neighbors of node j are
    ``indices[indptr[j]:indptr[j+1]]`` with matching ``edge_ids``."""
    indptr: np.ndarray
    indices: np.ndarray
    edge_ids: np.ndarray

    @staticmethod
    def from_coo(src: np.ndarray, dst: np.ndarray, num_dst: int) -> "CSC":
        order = np.argsort(dst, kind="stable")
        sdst = dst[order]
        indptr = np.zeros(num_dst + 1, np.int64)
        counts = np.bincount(sdst, minlength=num_dst)
        indptr[1:] = np.cumsum(counts)
        return CSC(indptr=indptr, indices=src[order].astype(np.int64),
                   edge_ids=order.astype(np.int64))


@dataclasses.dataclass
class DeviceCSR:
    """Device-resident dst-indexed adjacency for neighbor sampling.

    The same segments as :class:`CSC` as int32 tensors placed on a device
    once, so a minibatch ships only seed ids and the ``nbr_sample`` draw
    reads these tables.  ``col_idx``/``edge_id`` are padded to a multiple
    of ``pad_multiple`` (tail entries are never addressed by an unmasked
    draw), so they hold at least one entry even for an empty edge type.
    """
    row_ptr: torch.Tensor    # (num_dst + 1,) int32
    col_idx: torch.Tensor    # (E_pad,) int32
    edge_id: torch.Tensor    # (E_pad,) int32
    num_edges: int           # real (unpadded) edge count

    @staticmethod
    def from_csc(csc: CSC, device: torch.device,
                 pad_multiple: int = 128) -> "DeviceCSR":
        e = len(csc.indices)
        # e itself must fit: row_ptr[-1] == e (one past the largest edge id)
        checks = [(e, "edge count"), (int(csc.indptr[-1]), "indptr range")]
        if e:
            checks += [(int(csc.indices.max()), "node ids"),
                       (int(csc.edge_ids.max()), "edge ids")]
        for val, what in checks:
            if val >= 2 ** 31:
                raise ValueError(
                    f"{what} ({val}) exceeds the int32 device CSR range; "
                    f"graphs beyond 2^31 need an int64 path")
        e_pad = max(pad_multiple, -(-e // pad_multiple) * pad_multiple)
        col = np.zeros(e_pad, np.int32)
        eid = np.zeros(e_pad, np.int32)
        col[:e] = csc.indices
        eid[:e] = csc.edge_ids
        return DeviceCSR(
            row_ptr=torch.from_numpy(csc.indptr.astype(np.int32)).to(device),
            col_idx=torch.from_numpy(col).to(device),
            edge_id=torch.from_numpy(eid).to(device),
            num_edges=e)


class HeteroGraph:
    def __init__(self,
                 num_nodes: Dict[str, int],
                 edges: Dict[EType, Tuple[np.ndarray, np.ndarray]],
                 node_feats: Optional[Dict[str, Dict[str, np.ndarray]]] = None):
        self.num_nodes = dict(num_nodes)
        self.edges = {et: (np.asarray(s, np.int64), np.asarray(d, np.int64))
                      for et, (s, d) in edges.items()}
        self.node_feats = node_feats or {}
        self._csc: Dict[EType, CSC] = {}

    # ------------------------------------------------------------------
    @property
    def ntypes(self) -> List[str]:
        return sorted(self.num_nodes)

    @property
    def etypes(self) -> List[EType]:
        return sorted(self.edges)

    def num_edges(self, etype: Optional[EType] = None) -> int:
        if etype is not None:
            return len(self.edges[etype][0])
        return sum(len(s) for s, _ in self.edges.values())

    def csc(self, etype: EType) -> CSC:
        if etype not in self._csc:
            src, dst = self.edges[etype]
            self._csc[etype] = CSC.from_coo(src, dst,
                                            self.num_nodes[etype[2]])
        return self._csc[etype]

    def device_csr(self, etype: EType, device: torch.device) -> DeviceCSR:
        """The etype's adjacency as int32 tables on ``device``."""
        return DeviceCSR.from_csc(self.csc(etype), device)

    # ------------------------------------------------------------------
    def add_reverse_edges(self) -> "HeteroGraph":
        """Add (dst, rel-rev, src) for every etype, so message passing can
        flow both ways."""
        new_edges = dict(self.edges)
        for (s, r, d), (u, v) in self.edges.items():
            rev = (d, r + "-rev", s)
            if rev not in new_edges:
                new_edges[rev] = (v.copy(), u.copy())
        return HeteroGraph(self.num_nodes, new_edges, self.node_feats)

    def feat_dim(self, ntype: str, name: str = "feat") -> Optional[int]:
        f = self.node_feats.get(ntype, {}).get(name)
        return None if f is None else int(f.shape[1])

    def has_feat(self, ntype: str, name: str = "feat") -> bool:
        return name in self.node_feats.get(ntype, {})
