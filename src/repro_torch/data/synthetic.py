"""Synthetic MAG-shaped benchmark graph (the port's copy of
``repro.data.synthetic.make_mag_like``).

paper/author/institution/field; papers carry text + numeric features and
a venue label; authors are featureless.  Labels follow latent topics,
citations are topic-assortative and text tokens come from label-specific
vocabulary bands.  The generator is numpy end to end, so the same seed
gives the same arrays as the reference package.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.graph import HeteroGraph


def _topic_tokens(rng, topics, text_len, vocab, band_frac=0.5,
                  signal=0.7):
    """Token sequences whose distribution depends on the topic."""
    n = len(topics)
    n_topics = topics.max() + 1
    band = max(int(vocab * band_frac) // n_topics, 4)
    common_lo = band * n_topics
    use_band = rng.random((n, text_len)) < signal
    band_tok = (topics[:, None] * band
                + rng.integers(0, band, (n, text_len)))
    common_tok = rng.integers(common_lo, vocab, (n, text_len))
    toks = np.where(use_band, band_tok, common_tok)
    return toks + 1  # 0 reserved for pad


def _assortative_edges(rng, groups_src, groups_dst, n_edges, p_same=0.8):
    """Sample edges preferring same-group endpoints."""
    n_src, n_dst = len(groups_src), len(groups_dst)
    src = rng.integers(0, n_src, n_edges)
    dst = rng.integers(0, n_dst, n_edges)
    # rewire a fraction to same-group targets
    same = rng.random(n_edges) < p_same
    order = np.argsort(groups_dst, kind="stable")
    gsorted = groups_dst[order]
    ng = int(max(groups_src.max(), groups_dst.max())) + 1
    starts = np.searchsorted(gsorted, np.arange(ng + 1))
    g = groups_src[src[same]]
    lo, hi = starts[g], starts[g + 1]
    ok = hi > lo
    pick = lo + (rng.random(same.sum()) * np.maximum(hi - lo, 1)).astype(np.int64)
    dst_same = order[np.minimum(pick, len(order) - 1)]
    dst[np.nonzero(same)[0][ok]] = dst_same[ok]
    return src.astype(np.int64), dst.astype(np.int64)


def make_mag_like(n_paper=2000, n_author=1000, n_inst=64, n_field=32,
                  n_topics=8, feat_dim=32, text_len=16, vocab=2048,
                  avg_cites=6, feat_snr=0.6, text_signal=0.7,
                  seed=0) -> HeteroGraph:
    rng = np.random.default_rng(seed)
    topic = rng.integers(0, n_topics, n_paper)

    # paper numeric features: noisy topic encoding
    feat = rng.normal(0, 1, (n_paper, feat_dim)).astype(np.float32)
    feat[np.arange(n_paper), topic % feat_dim] += feat_snr * 3.0
    text = _topic_tokens(rng, topic, text_len, vocab, signal=text_signal)

    # citations: topic-assortative
    c_src, c_dst = _assortative_edges(rng, topic, topic,
                                      n_paper * avg_cites, p_same=0.8)
    # authors: featureless, each with a topic affinity
    a_topic = rng.integers(0, n_topics, n_author)
    w_dst, w_src = _assortative_edges(rng, a_topic, topic,
                                      n_paper * 3, p_same=0.7)
    # affiliation and fields
    inst = rng.integers(0, n_inst, n_author)
    f_src = np.arange(n_paper)
    noise = rng.random(n_paper) < 0.3
    field = np.where(noise, rng.integers(0, n_field, n_paper),
                     topic % n_field)

    g = HeteroGraph(
        num_nodes={"paper": n_paper, "author": n_author,
                   "institution": n_inst, "field": n_field},
        edges={
            ("paper", "cites", "paper"): (c_src, c_dst),
            ("author", "writes", "paper"): (w_dst, w_src),
            ("author", "affiliated", "institution"):
                (np.arange(n_author, dtype=np.int64), inst.astype(np.int64)),
            ("paper", "has_topic", "field"): (f_src.astype(np.int64),
                                              field.astype(np.int64)),
        },
        node_feats={
            "paper": {"feat": feat, "text": text, "label": topic.astype(np.int64)},
        },
    ).add_reverse_edges()
    return g
