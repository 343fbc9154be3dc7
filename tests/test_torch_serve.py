"""Serving node classification in the port against the reference: JAX
parameters and embedding tables carried across, served rows equal to
the reference's within rtol=atol=1e-5 (float sums and matmuls run in
another order), a round trip through a checkpoint the reference wrote,
and the port's own serving invariants (warm rows == cold rows ==
single-seed ``infer_device``, bitwise)."""
import json

import numpy as np
import pytest
import torch

from repro.checkpoint import save_trainer
from repro.checkpoint.io import _flatten
from repro.config import GSConfig as JaxGSConfig
from repro.runner import TASK_REGISTRY
from repro.runner import build_graph as jax_build_graph
from repro.serve import GSgnnInferenceService as JaxService
from repro_torch.checkpoint import (flatten_params, load_trainer,
                                    params_from_flat)
from repro_torch.cli.gs import main as gs_main
from repro_torch.common.device import resolve_device
from repro_torch.config import GSConfig
from repro_torch.runner import build_graph, build_inferer, run_config
from repro_torch.serve import (ContinuousBatcher, DeviceEmbeddingCache,
                               GSgnnInferenceService)

torch.set_num_threads(1)

B = 16
TOL = dict(rtol=1e-5, atol=1e-5)
RAW = {"task": "node_classification",
       "gnn": {"hidden": 16, "fanout": [2, 2], "use_pallas": True},
       "hyperparam": {"batch_size": B, "num_epochs": 1,
                      "sample_on_device": True},
       "input": {"dataset": "mag",
                 "dataset_conf": {"n_paper": 80, "n_author": 40}},
       "device_features": True,
       "node_classification": {}}
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def jax_trainer():
    cfg = JaxGSConfig.from_dict(RAW).resolved()
    return TASK_REGISTRY[cfg.task](cfg, jax_build_graph(cfg)).trainer


@pytest.fixture(scope="module")
def inferer(jax_trainer):
    """The port's inferer with the reference's weights and tables."""
    cfg = GSConfig.from_dict(RAW).resolved()
    inf = build_inferer(cfg, build_graph(cfg), CPU)
    inf.params = params_from_flat(_flatten(jax_trainer.params), CPU)
    for nt, emb in jax_trainer.sparse_embeds.items():
        inf.sparse_embeds[nt].load_state_dict(emb.state_dict())
    return inf


def _close(got, want):
    np.testing.assert_allclose(got["emb"], want["emb"], **TOL)
    np.testing.assert_allclose(got["out"], want["out"], **TOL)


def test_params_from_flat_keeps_every_leaf(jax_trainer, inferer):
    flat = _flatten(jax_trainer.params)
    have = flatten_params(inferer.params)
    assert sorted(have) == sorted(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(have[k].numpy(), v)
    assert isinstance(inferer.params["gnn"]["layers"], list)


@pytest.mark.parametrize("seeds", [[3, 7, 11, 2, 40], list(range(B)),
                                   [79, 0, 79, 5], [42]])
def test_infer_device_matches_reference(jax_trainer, inferer, seeds):
    _close(inferer.infer_device(seeds, batch_size=B),
           jax_trainer.infer_device(np.array(seeds), batch_size=B))


def test_served_rows_match_reference_service(jax_trainer, inferer):
    reqs = [np.array([5, 9]), np.array([9, 1, 5]), np.array([22]),
            np.arange(20, 40)]
    want = JaxService(jax_trainer, batch_size=B, cache_slots=0).serve(reqs)
    got = GSgnnInferenceService(inferer, batch_size=B,
                                cache_slots=0).serve(reqs)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["seeds"], w["seeds"])
        _close(g, w)


def test_served_rows_equal_single_seed_inference(inferer):
    """Seed-keyed draws: every served row is bit-identical to
    ``infer_device([seed])`` at the serving batch size, cold or warm."""
    reqs = [np.array([4, 4, 9, 4]), np.array([9, 2]), np.arange(30, 50),
            np.array([4, 31])]
    for slots in (0, 32):
        svc = GSgnnInferenceService(inferer, batch_size=B, cache_slots=slots)
        for _ in range(2):                    # second pass is warm
            for req, resp in zip(reqs, svc.serve(reqs)):
                for i, s in enumerate(req):
                    ref = inferer.infer_device([s], batch_size=B)
                    np.testing.assert_array_equal(resp["emb"][i],
                                                  ref["emb"][0])
                    np.testing.assert_array_equal(resp["out"][i],
                                                  ref["out"][0])
        if slots:
            assert svc.stats()["warm_rows"] > 0


def test_checkpoint_written_by_the_reference_round_trips(jax_trainer,
                                                         inferer, tmp_path):
    cfg = JaxGSConfig.from_dict(RAW).resolved()
    save_trainer(jax_trainer, str(tmp_path), config=cfg.to_dict())
    port_cfg = GSConfig.from_dict(json.loads(
        (tmp_path / "config.json").read_text())).resolved()
    fresh = build_inferer(port_cfg, build_graph(port_cfg), CPU)
    load_trainer(fresh, str(tmp_path))
    seeds = [1, 2, 3, 77]
    _close(fresh.infer_device(seeds, batch_size=B),
           jax_trainer.infer_device(np.array(seeds), batch_size=B))
    out = gs_main(["--serve", "--restore-model-path", str(tmp_path),
                   "--device", "cpu", "--serve.requests", "6"])
    assert out["requests_served"] == 6 and out["row_shapes"] == \
        {"emb": [16], "out": [8]}


def test_checkpoint_of_another_model_is_refused(jax_trainer, tmp_path):
    save_trainer(jax_trainer, str(tmp_path))
    raw = json.loads(json.dumps(RAW))
    raw["gnn"]["hidden"] = 8
    cfg = GSConfig.from_dict(raw).resolved()
    with pytest.raises(ValueError, match="does not match"):
        load_trainer(build_inferer(cfg, build_graph(cfg), CPU),
                     str(tmp_path))


def test_out_of_range_request_ids_are_refused(inferer):
    prog = inferer.device_infer_program(B)
    for bad in (80, -1):
        seeds = np.zeros(B, np.int64)
        seeds[3] = bad
        with pytest.raises(ValueError, match="seed ids"):
            prog(seeds)
    with pytest.raises(ValueError, match="padded"):
        prog(np.zeros(B + 1, np.int64))


def test_prefetch_returns_the_same_rows(inferer):
    prog = inferer.device_infer_program(B)
    seeds = np.arange(B)
    want = prog(seeds)
    prog.prefetch(seeds)
    got = prog(seeds)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_prefetch_of_older_params_is_not_returned(inferer):
    prog = inferer.device_infer_program(B)
    seeds = np.arange(B)
    want = prog(seeds)
    prog.prefetch(seeds)
    # mark the pending slot's rows, then restore weights (here the same
    # dict again, so only the params version can tell them apart)
    key, _ = prog._prefetched
    prog._prefetched = (key, tuple(torch.zeros_like(t) for t in want))
    inferer.params = inferer.params
    for a, b in zip(prog(seeds), want):
        assert torch.equal(a, b)


def test_entry_points_need_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_config(GSConfig.from_dict(RAW))
    assert resolve_device("cpu") == CPU


def test_cli_serves_a_json_config_on_cpu(tmp_path, capsys):
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(RAW))
    out = gs_main(["--serve", "--cf", str(path), "--device", "cpu",
                   "--serve.requests", "5", "--serve.cache_slots", "8"])
    assert out["requests_served"] == 5 and out["device"] == "cpu"
    assert json.loads(capsys.readouterr().out)["requests"] == 5
    with pytest.raises(SystemExit):
        gs_main(["--cf", str(path)])          # only --serve is ported


def test_expired_requests_are_shed_before_compute(inferer):
    now = [0.0]
    svc = GSgnnInferenceService(inferer, batch_size=B, cache_slots=0,
                                clock=lambda: now[0])
    dead = svc.submit([1, 2], deadline=1.0)
    live = svc.submit([3], priority="low")
    now[0] = 2.0
    svc.drain()
    assert svc.result(dead)["status"] == "expired"
    assert svc.result(live)["status"] == "done"
    st = svc.stats()
    assert st["shed_rows"] == 2 and st["computed_rows"] == 1
    with pytest.raises(ValueError, match="priority"):
        svc.submit([1], priority="urgent")


# ---------------------------------------------------------------------------
# cache and batcher units
# ---------------------------------------------------------------------------
def test_cache_drops_padding_rows_and_clips_gathers():
    cache = DeviceEmbeddingCache(capacity=4, max_staleness_steps=0)
    rows = (torch.arange(6.0).reshape(6, 1),)
    cache.insert([10, 11], rows, now_step=0)   # rows 2.. are padding
    assert len(cache) == 2
    slots, _ = cache.lookup([11, 10, 99], now_step=0)
    assert slots[2] == -1
    got = cache.gather(np.array([slots[0], slots[1], 4, -1]))[0]
    np.testing.assert_array_equal(got[:2, 0].numpy(), [1.0, 0.0])
    assert got.shape == (4, 1)                 # out-of-range slots clip
    assert not cache.fresh(10, now_step=1)     # staleness 0


def test_cache_evicts_least_recently_used():
    cache = DeviceEmbeddingCache(capacity=2)
    rows = (torch.zeros(2, 3),)
    cache.insert([1], rows, 0)
    cache.insert([2], rows, 0)
    cache.lookup([1], 0)                       # 2 is now LRU
    cache.insert([3], rows, 0)
    assert 1 in cache and 3 in cache and 2 not in cache
    assert cache.stats()["evictions"] == 1


def test_batcher_packs_like_the_reference():
    from repro.serve import ContinuousBatcher as JaxBatcher
    from repro.serve import ServeRequest as JaxRequest
    from repro_torch.serve import ServeRequest
    rng = np.random.default_rng(3)
    reqs = [rng.integers(0, 20, rng.integers(1, 9)) for _ in range(12)]
    batches = []
    for batcher_cls, req_cls in ((JaxBatcher, JaxRequest),
                                 (ContinuousBatcher, ServeRequest)):
        b = batcher_cls(5)
        for i, s in enumerate(reqs):
            b.add(req_cls(rid=i, seeds=s, t_submit=0.0,
                          rank=i % 2))
        out = []
        while len(b):
            items, compute = b.next_batch(lambda s: s % 7 == 0)
            out.append(([(r.rid, row, s) for r, row, s in items], compute))
        batches.append(out)
    assert batches[0] == batches[1]
