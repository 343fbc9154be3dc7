"""The port's DeviceNeighborSampler against the reference's (Pallas
draw, interpret mode): masks and frontier ids bitwise equal, in the
positional (step-keyed) and the seed-keyed mode."""
import numpy as np
import pytest
import torch

from repro.core.sampling import DeviceNeighborSampler as JaxSampler
from repro.data import make_mag_like as jax_make_mag_like
from repro_torch.core.sampling import DeviceNeighborSampler
from repro_torch.data import make_mag_like

torch.set_num_threads(1)

KW = dict(n_paper=80, n_author=40)


@pytest.fixture(scope="module")
def graphs():
    return jax_make_mag_like(**KW), make_mag_like(**KW)


def _draw_both(graphs, fanouts, seeds, step, seed_keyed, sampler_seed=0):
    ref_g, g = graphs
    ref = JaxSampler(ref_g, fanouts, seed=sampler_seed, use_pallas=True,
                     interpret=True)
    got = DeviceNeighborSampler(g, fanouts, seed=sampler_seed,
                                device=torch.device("cpu"))
    counts = {nt: len(ids) for nt, ids in seeds.items()}
    want = ref.sample(ref.tables, ref.plan_for(counts),
                      {nt: np.asarray(ids, np.int32)
                       for nt, ids in seeds.items()},
                      step, seed_keyed=seed_keyed)
    have = got.sample(got.plan_for(counts),
                      {nt: torch.as_tensor(ids) for nt, ids in seeds.items()},
                      step, seed_keyed=seed_keyed)
    return want, have


def _assert_equal(want, have):
    w_masks, _, w_front = want
    h_masks, h_dts, h_front = have
    assert len(w_masks) == len(h_masks)
    for wm, hm in zip(w_masks, h_masks):
        assert sorted(wm) == sorted(hm)
        for k in wm:
            np.testing.assert_array_equal(hm[k].numpy(), np.asarray(wm[k]))
    assert all(d == {} for d in h_dts)
    assert sorted(w_front) == sorted(h_front)
    for nt in w_front:
        assert h_front[nt].dtype == torch.int32
        np.testing.assert_array_equal(h_front[nt].numpy(),
                                      np.asarray(w_front[nt]))


@pytest.mark.parametrize("seed_keyed", [False, True])
# equal batch sizes keep the reference's compiled draws cached across cases
@pytest.mark.parametrize("fanouts,step,seeds", [
    ([2, 2], 0, {"paper": [3, 7, 11, 2, 40, 79, 0, 3]}),
    ([2, 2], 5, {"paper": list(range(8))}),
    ([2, 2], 1, {"author": [0, 39, 5, 5, 1, 2, 3, 38]}),
])
def test_sample_matches_reference(graphs, fanouts, step, seeds, seed_keyed):
    _assert_equal(*_draw_both(graphs, fanouts, seeds, step, seed_keyed))


def test_sample_matches_reference_with_another_seed(graphs):
    _assert_equal(*_draw_both(graphs, [2, 2],
                              {"paper": [1, 2, 3, 4, 5, 6, 7, 79]}, 2,
                              True, sampler_seed=123))


def test_seed_keyed_rows_do_not_depend_on_batch(graphs):
    """A seed's draws are the same wherever it sits in the batch."""
    _, g = graphs
    s = DeviceNeighborSampler(g, [2, 2], device=torch.device("cpu"))
    a = s.sample(s.plan_for({"paper": 3}), {"paper": torch.tensor([5, 6, 7])},
                 step=0, seed_keyed=True)[0]
    b = s.sample(s.plan_for({"paper": 3}), {"paper": torch.tensor([7, 5, 6])},
                 step=4, seed_keyed=True)[0]
    top_a, top_b = a[-1], b[-1]
    for k in top_a:
        np.testing.assert_array_equal(top_a[k][0].numpy(),
                                      top_b[k][1].numpy())


@pytest.mark.parametrize("kw", [{"exclude": {}}, {"dp": ("data", 2)},
                                {"shard": ("data", 2)}])
def test_unported_sampling_modes_raise(graphs, kw):
    _, g = graphs
    s = DeviceNeighborSampler(g, [2, 2], device=torch.device("cpu"))
    with pytest.raises(NotImplementedError):
        s.sample(s.plan_for({"paper": 2}), {"paper": torch.tensor([0, 1])},
                 **kw)
