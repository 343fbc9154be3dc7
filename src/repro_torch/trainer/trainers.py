"""Node-task inference on the device: the serving counterpart of the
reference's trainer + ``DeviceInferProgram``.

``GSgnnNodeInferer`` holds what serving reads: the parameters, the
device feature store, the embedding tables of featureless ntypes and the
device sampler.  ``DeviceInferProgram`` runs sample -> gather -> GNN ->
task head over one fixed ``(batch_size,)`` seed vector.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.common.device import resolve_device
from repro_torch.core.sampling import pad_seeds
from repro_torch.gnn.decoders import decoder_apply, init_decoder
from repro_torch.gnn.model import GSgnnModel, gnn_apply_blocks, init_gnn_model
from repro_torch.gnn.schema import schema_of_plan


def serve_head(params, task: str, emb: torch.Tensor, ntype: str):
    """The task's serving head over seed embeddings (node tasks: the
    decoder's logits)."""
    return decoder_apply(params["dec"], task, {ntype: emb},
                         target_ntype=ntype)


class GSgnnNodeInferer:
    """Parameters + tables + sampler of one node-task model, on one
    device.  Without ``params`` the weights are drawn from ``generator``
    (``checkpoint.io.load_trainer`` replaces them with trained ones)."""

    def __init__(self, model: GSgnnModel, target_ntype: str,
                 num_classes: int, *, device,
                 device_sampler, feature_store,
                 sparse_embeds: Optional[Dict] = None,
                 task: str = "node_classification",
                 params: Optional[dict] = None,
                 generator: Optional[torch.Generator] = None):
        self.model = model
        self.task = task
        self.target_ntype = target_ntype
        self.device = resolve_device(device)
        if params is None:
            params = {
                "gnn": init_gnn_model(model, generator, self.device),
                "dec": init_decoder(task, model.hidden, num_classes,
                                    generator, self.device)}
        self.params_version = 0
        self.params = params
        self.device_sampler = device_sampler
        self.feature_store = feature_store
        self.sparse_embeds = sparse_embeds or {}
        self._programs: Dict[int, DeviceInferProgram] = {}

    @property
    def params(self) -> dict:
        return self._params

    @params.setter
    def params(self, params: dict) -> None:
        """Replacing the weights advances ``params_version``, which keys
        the programs' prefetch slots."""
        self._params = params
        self.params_version += 1

    def device_infer_program(self, batch_size: int) -> "DeviceInferProgram":
        batch_size = int(batch_size)
        if batch_size not in self._programs:
            self._programs[batch_size] = DeviceInferProgram(self, batch_size)
        return self._programs[batch_size]

    def infer_device(self, seeds, batch_size: Optional[int] = None):
        """Offline reference inference: pad ``seeds`` to ``batch_size``
        (default: their own length) and run the program once.  Returns
        host arrays ``{"emb": (n, hidden), "out": (n, num_classes)}``.

        The program's draws are seed-keyed, so each row is a pure
        function of its seed id: the serving parity anchor."""
        ids = np.asarray(seeds, np.int64).reshape(-1)
        padded, _ = pad_seeds(ids, int(batch_size or len(ids)))
        emb, out = self.device_infer_program(len(padded))(padded)
        n = len(ids)
        return {"emb": emb.cpu().numpy()[:n], "out": out.cpu().numpy()[:n]}


class DeviceInferProgram:
    """sample -> gather -> GNN -> task head over a fixed
    ``(batch_size,)``-padded seed vector of the serving ntype.

    Calls read the inferer's *current* params and tables, so a restore
    after construction is picked up.  The launches are asynchronous;
    ``prefetch`` issues a batch ahead so its device work overlaps the
    host's handling of the current one."""

    def __init__(self, trainer: GSgnnNodeInferer, batch_size: int):
        self.trainer = trainer
        self.ntype = trainer.target_ntype
        self.batch_size = int(batch_size)
        self.num_nodes = trainer.device_sampler.g.num_nodes[self.ntype]
        self.plan = trainer.device_sampler.plan_for(
            {self.ntype: self.batch_size})
        self.schema = schema_of_plan(self.plan)
        input_nts = [nt for nt, _ in self.plan.layers[0].src_counts]
        store = trainer.feature_store
        self.store_nts = tuple(nt for nt in input_nts if nt in store)
        self.sparse_nts = tuple(nt for nt in input_nts
                                if nt not in store
                                and nt in trainer.sparse_embeds)
        missing = [nt for nt in input_nts if nt in
                   dict(trainer.model.feat_dims)
                   and nt not in self.store_nts + self.sparse_nts]
        if missing:
            raise ValueError(f"ntypes {missing} have input features in the "
                             f"model but no feature table or embedding")
        # one-slot prefetch: (key, device result) of a batch issued ahead
        self._prefetched = None

    def _run(self, seeds: np.ndarray):
        tr = self.trainer
        nt = self.ntype
        ids = torch.from_numpy(seeds.astype(np.int32)).to(tr.device)
        masks, _, frontier = tr.device_sampler.sample(
            self.plan, {nt: ids}, seed_keyed=True)
        feats = {m: tr.feature_store.gather(m, frontier[m])
                 for m in self.store_nts}
        feats.update({m: tr.sparse_embeds[m].lookup(frontier[m])
                      for m in self.sparse_nts})
        emb = gnn_apply_blocks(tr.params["gnn"], tr.model, self.schema,
                               {"masks": masks, "feats": feats})[nt]
        return emb, serve_head(tr.params, tr.task, emb, nt)

    def _check_seeds(self, seeds) -> np.ndarray:
        seeds = np.asarray(seeds)
        if seeds.shape != (self.batch_size,):
            raise ValueError(
                f"expected a padded ({self.batch_size},) seed vector, got "
                f"shape {tuple(seeds.shape)} — pad with "
                f"repro_torch.core.sampling.pad_seeds")
        if not np.issubdtype(seeds.dtype, np.integer):
            raise TypeError(f"seed ids must be integers, got {seeds.dtype}")
        if len(seeds) and (seeds.min() < 0 or seeds.max() >= self.num_nodes):
            raise ValueError(
                f"seed ids must lie in [0, {self.num_nodes}) for ntype "
                f"{self.ntype!r}; got ids in [{seeds.min()}, {seeds.max()}]")
        return seeds

    def _key_of(self, seeds: np.ndarray):
        # draws are seed-keyed, so the seed bytes identify the result;
        # the params version guards against a restore between prefetch
        # and use
        return (seeds.astype(np.int64).tobytes(),
                self.trainer.params_version)

    def prefetch(self, seeds):
        """Issue the program for an upcoming batch without waiting."""
        seeds = self._check_seeds(seeds)
        key = self._key_of(seeds)
        if self._prefetched is not None and self._prefetched[0] == key:
            return
        self._prefetched = (key, self._run(seeds))

    def __call__(self, seeds):
        """One padded batch -> device ``(emb, out)`` of shape
        ``(batch_size, ...)`` (rows beyond the real seeds are padding)."""
        seeds = self._check_seeds(seeds)
        if self._prefetched is not None:
            key, result = self._prefetched
            self._prefetched = None
            if key == self._key_of(seeds):
                return result
        return self._run(seeds)
