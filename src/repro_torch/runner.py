"""Run assembly behind ``python -m repro_torch.cli.gs``.

One resolved ``GSConfig`` drives the run: the ``input`` section builds
the graph, the ``gnn`` section the model and the embedding tables of
featureless node types, and the task section the inferer.  The port
covers the serving path of node classification so far: the inferer answers a
synthetic request stream through ``GSgnnInferenceService``, with
weights restored from ``output.restore_model_path`` (a checkpoint the
reference package wrote) or drawn from ``hyperparam.seed``.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.checkpoint import load_trainer
from repro_torch.common.device import resolve_device
from repro_torch.config import GSConfig, ServeConfig
from repro_torch.core.embedding import SparseEmbedding
from repro_torch.core.feature_store import DeviceFeatureStore
from repro_torch.core.graph import HeteroGraph
from repro_torch.core.sampling import DeviceNeighborSampler
from repro_torch.data import make_mag_like
from repro_torch.gnn.model import model_meta_from_graph
from repro_torch.serve import GSgnnInferenceService, request_stream
from repro_torch.trainer import GSgnnNodeInferer

_SYNTHETIC = {"mag": make_mag_like}


def build_graph(cfg: GSConfig) -> HeteroGraph:
    """input section -> HeteroGraph of a built-in synthetic family."""
    return _SYNTHETIC[cfg.input.dataset](seed=cfg.hyperparam.seed,
                                         **dict(cfg.input.dataset_conf))


def sparse_embeds_for(graph: HeteroGraph, dim: int, device: torch.device,
                      generator: torch.Generator,
                      feat_field: str = "feat"
                      ) -> Dict[str, SparseEmbedding]:
    """One embedding table per featureless node type, in ntype order."""
    return {nt: SparseEmbedding(graph.num_nodes[nt], dim, device, name=nt,
                                generator=generator)
            for nt in graph.ntypes if not graph.has_feat(nt, feat_field)}


def build_inferer(cfg: GSConfig, graph: HeteroGraph,
                  device: torch.device) -> GSgnnNodeInferer:
    """Model, tables and sampler of a resolved node-classification
    config on ``device``; random weights come from ``hyperparam.seed``."""
    ff = cfg.input.feat_field
    gen = torch.Generator().manual_seed(cfg.hyperparam.seed)
    sparse = sparse_embeds_for(graph, cfg.gnn.sparse_embed_dim, device,
                               gen, ff)
    model = model_meta_from_graph(
        graph, cfg.gnn.model, hidden=cfg.gnn.hidden,
        num_layers=cfg.gnn.num_layers,
        extra_feat_dims={nt: cfg.gnn.sparse_embed_dim for nt in sparse},
        feat_field=ff)
    nc = cfg.node_classification
    return GSgnnNodeInferer(
        model, nc.target_ntype, nc.num_classes, device=device,
        device_sampler=DeviceNeighborSampler(
            graph, cfg.gnn.fanout, seed=cfg.hyperparam.seed, device=device),
        feature_store=DeviceFeatureStore(graph, device, feat_field=ff),
        sparse_embeds=sparse, generator=gen)


def serve(cfg: GSConfig, inferer: GSgnnNodeInferer,
          graph: HeteroGraph) -> dict:
    """Drain the config's synthetic request stream through the batched
    inference service; returns latency percentiles, throughput and cache
    counters."""
    sv = cfg.serve if cfg.serve is not None else ServeConfig()
    svc = GSgnnInferenceService(
        inferer, batch_size=sv.batch_size or cfg.hyperparam.batch_size,
        cache_slots=sv.cache_slots,
        max_staleness_steps=sv.max_staleness_steps)
    reqs = request_stream(
        graph.num_nodes[svc.ntype], num_requests=sv.requests,
        request_size=sv.request_size, hot_fraction=sv.hot_fraction,
        hot_set=sv.hot_set, seed=cfg.hyperparam.seed)
    responses = svc.serve(reqs)
    out = {"task": cfg.task, "serve_ntype": svc.ntype,
           "batch_size": svc.batch_size, "device": str(inferer.device),
           "row_shapes": {"emb": list(responses[0]["emb"].shape[1:]),
                          "out": list(responses[0]["out"].shape[1:])}}
    out.update(svc.stats())
    return out


def run_config(cfg: GSConfig, device: Optional[str] = None) -> dict:
    """The programmatic entry point: resolve the config, build the graph
    and the inferer on ``device`` (CUDA unless the caller names the
    CPU), restore weights if asked, and serve."""
    cfg = cfg.resolved()
    dev = resolve_device(device)
    graph = build_graph(cfg)
    inferer = build_inferer(cfg, graph, dev)
    if cfg.output.restore_model_path:
        load_trainer(inferer, cfg.output.restore_model_path)
    return serve(cfg, inferer, graph)
