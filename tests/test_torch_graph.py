"""The port's graph, CSR, sample plan, block schema and config against
the reference package: the same numpy inputs give equal results."""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from repro.config import GSConfig as JaxGSConfig
from repro.core.graph import CSC as JaxCSC
from repro.core.graph import DeviceCSR as JaxDeviceCSR
from repro.core.sampling import plan_sample as jax_plan_sample
from repro.data import make_mag_like as jax_make_mag_like
from repro.gnn.schema import schema_of_plan as jax_schema_of_plan
from repro_torch.config import ConfigError, GSConfig, load_config_dict
from repro_torch.core.graph import CSC, DeviceCSR
from repro_torch.core.sampling import pad_seeds, plan_sample
from repro_torch.data import make_mag_like
from repro_torch.gnn.schema import schema_of_plan

torch.set_num_threads(1)

CPU = torch.device("cpu")
SIZES = [dict(n_paper=80, n_author=40, seed=0),
         dict(n_paper=150, n_author=30, n_inst=5, n_field=3, seed=7)]


@pytest.fixture(scope="module", params=range(len(SIZES)))
def graphs(request):
    kw = SIZES[request.param]
    return jax_make_mag_like(**kw), make_mag_like(**kw)


def test_make_mag_like_arrays_equal(graphs):
    ref, got = graphs
    assert got.num_nodes == ref.num_nodes
    assert got.ntypes == ref.ntypes and got.etypes == ref.etypes
    for et in ref.etypes:
        for a, b in zip(ref.edges[et], got.edges[et]):
            np.testing.assert_array_equal(a, b)
    for nt, feats in ref.node_feats.items():
        assert set(feats) == set(got.node_feats[nt])
        for name, arr in feats.items():
            np.testing.assert_array_equal(arr, got.node_feats[nt][name])


def test_device_csr_tables_equal(graphs):
    ref, got = graphs
    for et in ref.etypes:
        want = JaxDeviceCSR.from_csc(ref.csc(et))
        csr = got.device_csr(et, CPU)
        assert csr.num_edges == want.num_edges
        for name in ("row_ptr", "col_idx", "edge_id"):
            t = getattr(csr, name)
            assert t.dtype == torch.int32
            np.testing.assert_array_equal(t.numpy(),
                                          np.asarray(getattr(want, name)))


@pytest.mark.parametrize("e", [0, 1, 127, 128, 129])
def test_device_csr_pads_to_128(e):
    src = np.arange(e, dtype=np.int64) % 3
    dst = np.arange(e, dtype=np.int64) % 5
    csr = DeviceCSR.from_csc(CSC.from_coo(src, dst, 5), CPU)
    want = JaxDeviceCSR.from_csc(JaxCSC.from_coo(src, dst, 5))
    assert csr.col_idx.shape[0] == np.asarray(want.col_idx).shape[0] == \
        max(128, -(-e // 128) * 128)
    np.testing.assert_array_equal(csr.row_ptr.numpy(),
                                  np.asarray(want.row_ptr))


@pytest.mark.parametrize("field", ["indices", "edge_ids"])
def test_device_csr_refuses_ids_beyond_int32(field):
    csc = CSC.from_coo(np.array([0, 1]), np.array([0, 0]), 1)
    getattr(csc, field)[1] = 2 ** 31
    with pytest.raises(ValueError, match="int32"):
        DeviceCSR.from_csc(csc, CPU)


@pytest.mark.parametrize("fanouts,seeds", [
    ([2, 2], {"paper": 16}),
    ([5, 5], {"paper": 64}),
    ([3, 1, 2], {"paper": 7}),
    ([2, 2], {"author": 4}),
    ([{}, 2], {"field": 3}),
])
def test_plan_and_schema_equal(graphs, fanouts, seeds):
    ref, got = graphs
    if isinstance(fanouts[0], dict):   # per-etype fanout dicts
        fanouts = [{et: 1 + i % 3 for i, et in enumerate(ref.etypes)},
                   fanouts[1]]
    want = jax_plan_sample(ref, fanouts, seeds)
    plan = plan_sample(got, fanouts, seeds)
    assert dataclasses.astuple(plan) == dataclasses.astuple(want)
    assert dataclasses.astuple(schema_of_plan(plan)) == \
        dataclasses.astuple(jax_schema_of_plan(want))


def test_pad_seeds():
    padded, mask = pad_seeds(np.array([4, 9]), 5)
    np.testing.assert_array_equal(padded, [4, 9, 0, 0, 0])
    np.testing.assert_array_equal(mask, [True, True, False, False, False])
    with pytest.raises(ValueError):
        pad_seeds(np.arange(6), 5)


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------
RAW = {"task": "node_classification",
       "gnn": {"hidden": 16, "fanout": [2, 2], "use_pallas": True},
       "hyperparam": {"batch_size": 16, "sample_on_device": True},
       "input": {"dataset": "mag",
                 "dataset_conf": {"n_paper": 80, "n_author": 40}},
       "device_features": True, "node_classification": {},
       "serve": {"cache_slots": 32}}


def test_config_persisted_by_the_reference_loads():
    """A resolved config the reference writes next to a checkpoint
    loads into the port and resolves to the same targets."""
    raw = json.loads(json.dumps(JaxGSConfig.from_dict(RAW).resolved()
                                .to_dict()))
    cfg = GSConfig.from_dict(raw).resolved()
    assert cfg.to_dict() == raw


def test_config_json_file_and_defaults(tmp_path):
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(RAW))
    cfg = GSConfig.from_file(str(path), overrides=["--gnn.hidden", "32",
                                                   "serve.requests=8"])
    nc = cfg.resolved().node_classification
    assert (nc.target_ntype, nc.num_classes) == ("paper", 8)
    assert cfg.gnn.hidden == 32 and cfg.serve.requests == 8


def test_config_reads_the_example_yaml():
    raw = load_config_dict(os.path.join(os.path.dirname(__file__), "..",
                                        "examples", "configs",
                                        "nc_mag_device.yaml"))
    cfg = GSConfig.from_dict(raw)
    assert cfg.gnn.fanout == [5, 5] and cfg.gnn.hidden == 64


@pytest.mark.parametrize("patch,match", [
    ({"gnn": {"hiden": 3}}, "did you mean 'hidden'"),
    ({"gnn": {"model": "sage"}}, "not one of"),
    ({"gnn": {"fanout": [2]}}, "one entry per GNN layer"),
    ({"serve": {"num_replicas": 2}}, "only the default"),
    ({"serve": {"port": 8080}}, "only the default"),
    ({"task": "link_prediction"}, "not one of"),
])
def test_config_rejects(patch, match):
    raw = json.loads(json.dumps(RAW))
    for k, v in patch.items():
        if isinstance(v, dict):
            raw[k].update(v)
        else:
            raw[k] = v
    with pytest.raises(ConfigError, match=match):
        GSConfig.from_dict(raw)
