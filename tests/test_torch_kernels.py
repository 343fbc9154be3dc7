"""The port's kernels: plain PyTorch versions against the reference's
oracles and Pallas kernels (interpret mode) on the same numpy inputs,
the wrappers' input checks, and — on a CUDA card — the CUDA kernels
against the plain versions.

The reference is imported inside the ``ref`` fixture, so the card-only
tests also run where JAX is not installed:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels.py``.
"""
import types

import numpy as np
import pytest
import torch

from repro_torch.core import prng
from repro_torch.kernels.nbr_sample import (nbr_sample, nbr_sample_cuda,
                                            nbr_sample_ref)
from repro_torch.kernels.nbr_sample import ops as ns_ops
from repro_torch.kernels.seg_aggr import (gather_seg_aggr,
                                          gather_seg_aggr_cuda,
                                          gather_seg_aggr_ref)
from repro_torch.kernels.seg_aggr import ops as sa_ops

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ref():
    """The reference package's kernels (needs JAX)."""
    jax = pytest.importorskip("jax")
    from repro.kernels.nbr_sample import nbr_sample, nbr_sample_pallas
    from repro.kernels.nbr_sample import nbr_sample_ref
    from repro.kernels.seg_aggr.kernel import gather_seg_aggr_pallas
    return types.SimpleNamespace(
        jax=jax, jnp=jax.numpy, nbr_sample=nbr_sample,
        nbr_sample_pallas=nbr_sample_pallas, nbr_sample_ref=nbr_sample_ref,
        gather_seg_aggr_pallas=gather_seg_aggr_pallas)


NS_SHAPES = [(1, 1, 128), (37, 5, 128), (200, 7, 256), (130, 3, 384)]
SA_SHAPES = [(50, 1, 1, 64), (300, 37, 5, 16), (40, 33, 7, 3),
             (64, 130, 2, 130)]


def _ns_inputs(n, f, e, seed=0):
    """Random draws with zero-degree rows and a segment running past the
    table end (clamped)."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2 ** 32, (n, f), dtype=np.uint64) \
        .astype(np.uint32)
    bits[0, 0] = 2 ** 32 - 1
    degs = rng.integers(0, 9, n).astype(np.int32)
    degs[::3] = 0
    starts = rng.integers(0, e, n).astype(np.int32)
    starts[-1], degs[-1] = e - 1, 6
    col = rng.integers(0, 10 ** 6, e).astype(np.int32)
    eid = rng.integers(0, 10 ** 6, e).astype(np.int32)
    return bits, starts, degs, col, eid


def _to_torch(bits, *rest):
    return (torch.from_numpy(bits.view(np.int32)),
            *(torch.from_numpy(a) for a in rest))


@pytest.mark.parametrize("shape", NS_SHAPES)
def test_nbr_sample_plain_matches_oracle_and_pallas(ref, shape):
    args = _ns_inputs(*shape)
    got = nbr_sample_ref(*_to_torch(*args))
    jargs = [ref.jnp.asarray(a) for a in args]
    for want in (ref.nbr_sample_ref(*jargs),
                 ref.nbr_sample_pallas(*jargs, interpret=True)):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("fanout", [1, 4])
@pytest.mark.parametrize("step", [0, 9])
def test_nbr_sample_entry_matches_reference_entry(ref, fanout, step):
    """Bits from the port's threefry + the plain draw == the reference's
    jax.random bits + its Pallas draw, bit for bit."""
    rng = np.random.default_rng(step)
    deg = rng.integers(0, 5, 30)
    row_ptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    e_pad = max(128, -(-int(row_ptr[-1]) // 128) * 128)
    col = rng.integers(0, 50, e_pad).astype(np.int32)
    eid = np.arange(e_pad, dtype=np.int32)
    dst = rng.integers(0, 30, 20).astype(np.int32)
    jnp = ref.jnp
    key = ref.jax.random.fold_in(ref.jax.random.PRNGKey(4), step)
    want = ref.nbr_sample(jnp.asarray(row_ptr), jnp.asarray(col),
                          jnp.asarray(eid), jnp.asarray(dst), key,
                          fanout=fanout, use_pallas=True, interpret=True)
    got = nbr_sample(torch.from_numpy(row_ptr), torch.from_numpy(col),
                     torch.from_numpy(eid), torch.from_numpy(dst),
                     prng.fold_in(prng.PRNGKey(4), step), fanout=fanout)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _sa_inputs(big_n, n, f, d, seed=0):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(big_n, d)).astype(np.float32)
    idx = rng.integers(0, big_n, (n, f)).astype(np.int32)
    mask = rng.random((n, f)) < 0.7
    mask[::4] = False                      # fully-masked rows
    return table, idx, mask


@pytest.mark.parametrize("shape", SA_SHAPES)
@pytest.mark.parametrize("reduce", ["mean", "sum", "max"])
def test_gather_seg_aggr_plain_matches_pallas(ref, shape, reduce):
    table, idx, mask = _sa_inputs(*shape)
    jnp = ref.jnp
    want = np.asarray(ref.gather_seg_aggr_pallas(
        jnp.asarray(table), jnp.asarray(idx), jnp.asarray(mask), reduce,
        interpret=True))
    got = gather_seg_aggr(torch.from_numpy(table), torch.from_numpy(idx),
                          torch.from_numpy(mask), reduce).numpy()
    if reduce == "max":
        np.testing.assert_array_equal(got, want)
    else:
        # float sums over the fanout in another order: rtol=atol=1e-6
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert not got[::4].any()              # fully-masked rows give 0


def test_cpu_tensors_never_launch_a_kernel():
    before = (ns_ops.KERNEL.launches, sa_ops.KERNEL.launches)
    nbr_sample_ref(*_to_torch(*_ns_inputs(5, 2, 128)))
    gather_seg_aggr(*(torch.from_numpy(a) for a in _sa_inputs(9, 4, 2, 8)))
    assert (ns_ops.KERNEL.launches, sa_ops.KERNEL.launches) == before


def test_wrappers_refuse_cpu_tensors_and_bad_reduce():
    with pytest.raises(ValueError, match="CUDA"):
        nbr_sample_cuda(*_to_torch(*_ns_inputs(5, 2, 128)))
    t = [torch.from_numpy(a) for a in _sa_inputs(9, 4, 2, 8)]
    with pytest.raises(ValueError, match="CUDA"):
        gather_seg_aggr_cuda(*t)
    with pytest.raises(ValueError, match="reduce"):
        gather_seg_aggr(*t, reduce="min")


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", NS_SHAPES)
def test_nbr_sample_kernel_matches_plain_on_card(cuda, shape):
    args = [t.to(cuda) for t in _to_torch(*_ns_inputs(*shape))]
    before = ns_ops.KERNEL.launches
    got = nbr_sample_cuda(*args)
    torch.cuda.synchronize()
    assert ns_ops.KERNEL.launches == before + 1
    for a, b in zip(got, nbr_sample_ref(*args)):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SA_SHAPES)
@pytest.mark.parametrize("reduce", ["mean", "sum", "max"])
def test_gather_seg_aggr_kernel_matches_plain_on_card(cuda, shape, reduce):
    args = [torch.from_numpy(a).to(cuda) for a in _sa_inputs(*shape)]
    got = gather_seg_aggr_cuda(*args, reduce)
    want = gather_seg_aggr_ref(*args, reduce)
    torch.cuda.synchronize()
    if reduce == "max":
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
