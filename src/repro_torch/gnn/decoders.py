"""Task decoders (node classification so far)."""
from __future__ import annotations

from typing import Dict

import torch

NODE_TASKS = ("node_classification",)


def init_decoder(task: str, hidden: int, out_dim: int,
                 generator: torch.Generator, device: torch.device):
    """Two-layer MLP head, scaled as in the reference."""
    if task not in NODE_TASKS:
        raise ValueError(f"decoder for {task!r} is not ported yet")
    w1 = torch.randn((hidden, hidden), generator=generator) * hidden ** -0.5
    w2 = torch.randn((hidden, out_dim), generator=generator) * hidden ** -0.5
    return {"w1": w1.to(device), "b1": torch.zeros(hidden, device=device),
            "w2": w2.to(device), "b2": torch.zeros(out_dim, device=device)}


def _mlp(p, x):
    h = torch.relu(x @ p["w1"] + p["b1"])
    return h @ p["w2"] + p["b2"]


def decoder_apply(params, task: str, emb: Dict[str, torch.Tensor],
                  target_ntype: str):
    if task not in NODE_TASKS:
        raise ValueError(f"decoder for {task!r} is not ported yet")
    return _mlp(params, emb[target_ntype])
