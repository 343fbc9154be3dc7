"""Batched GNN inference serving on the device.

Request queue -> continuous batching into the static sample plan -> one
device program for cold seeds -> device-resident LRU embedding cache
(staleness-bounded) for warm seeds.  Entry points:
``GSgnnInferenceService`` (programmatic), ``gs --serve`` (CLI).
"""
from repro_torch.serve.batcher import ContinuousBatcher, ServeRequest
from repro_torch.serve.cache import DeviceEmbeddingCache
from repro_torch.serve.service import (GSgnnInferenceService, LatencyRing,
                                       request_stream)

__all__ = ["ContinuousBatcher", "DeviceEmbeddingCache",
           "GSgnnInferenceService", "LatencyRing", "ServeRequest",
           "request_stream"]
