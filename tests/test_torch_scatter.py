"""Parity of the port's BA scatter and gather (`ops/scatter.py`) with the JAX
package's `ops/pallas_scatter.py`: the plain versions against the XLA forms
and against the Pallas kernels in interpret mode, on the shapes of
`tests/test_pallas_scatter.py` (unaligned F=130, P=260) and on adversarial
index sets (a row's features all in one column tile, rows of -1, indices at
and past P, long runs of one index), K2's values as the [L,G,F] view of
feature-major storage that `bundle_adjust` passes. K2 to rtol/atol 1e-5
(f32 sums in another order), K3 exact (a copy). The hand-written kernels
K2/K3 run only on a card (`cuda` marker)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dvm_slam_tpu.ops import pallas_scatter as ps

from dvm_slam_tpu_torch.ops import scatter, scatter_kernel
from dvm_slam_tpu_torch.utils import profiling

torch.set_num_threads(2)


def _adjoint_inputs(seed, L=5, G=30, F=130, P=260):
    rng = np.random.RandomState(seed)
    vals = rng.randn(L, G, F).astype(np.float32)
    pidx = rng.randint(-1, P, (L, F)).astype(np.int32)
    pidx[1, 10:40] = 7          # one point observed many times in a row
    pidx[-1] = -1               # a row with no observation
    return vals, pidx, P


def _gather_inputs(seed, G=3, P=260, L=5, F=130):
    rng = np.random.RandomState(seed)
    pts = rng.randn(G, P).astype(np.float32)
    pidx = rng.randint(-1, P, (L, F)).astype(np.int32)
    pidx[0, :20] = P - 1
    pidx[-1] = -1
    return pts, pidx


def _adversarial_pidx(name, L=5, F=130, P=260, seed=11):
    """[L,F] int32 index sets that corner a column-tiled scatter."""
    rng = np.random.RandomState(seed)
    if name == "random":
        pidx = rng.randint(-1, P, (L, F))
    elif name == "one tile":          # every feature of a row in columns [128, 256)
        pidx = rng.randint(128, 256, (L, F))
        pidx[0] = 200                 # one point at every feature
    elif name == "rows of -1":
        pidx = rng.randint(-1, P, (L, F))
        pidx[::2] = -1
    elif name == "index = P":
        pidx = rng.choice([-1, 0, P - 1, P, P + 1], (L, F))
    else:                             # "duplicate runs": 32 features at a time on one point
        pidx = np.repeat(rng.randint(-1, P, (L, -(-F // 32))), 32, axis=1)[:, :F]
    return pidx.astype(np.int32)


ADVERSARIAL = ["random", "one tile", "rows of -1", "index = P", "duplicate runs"]


def _ba_view(vals):
    """[L,G,F] values as `bundle_adjust` hands them over: an [L,G,F] view of
    feature-major [L,F,G] storage."""
    return torch.from_numpy(np.ascontiguousarray(vals.transpose(0, 2, 1))).permute(0, 2, 1)


@pytest.mark.parametrize("index_set", ADVERSARIAL)
@pytest.mark.parametrize("case", ["adjoint/xla", "adjoint/pallas", "ordered/xla",
                                  "gather/row gather", "gather/pallas"])
def test_plain_matches_reference_on_adversarial_indices(case, index_set):
    """The port's plain versions (and K2's ascending-f twin) against the JAX
    package's XLA forms and Pallas kernels (interpret mode). The reference's
    CPU row gather clamps an index >= P where the Pallas kernel and the port
    give 0; no call site produces one, so that reference is compared with
    those slots set to 0."""
    fn, ref = case.split("/")
    L, F, P = 5, 130, 260
    pidx = _adversarial_pidx(index_set, L, F, P)
    rng = np.random.RandomState(12)
    if fn == "gather":
        pts = rng.randn(3, P).astype(np.float32)
        got = scatter.onehot_gather_plain(torch.from_numpy(pts), torch.from_numpy(pidx)).numpy()
        if ref == "pallas":
            want = np.asarray(ps.onehot_gather_pallas(jnp.asarray(pts), jnp.asarray(pidx),
                                                      interpret=True))
        else:
            want = np.asarray(ps.onehot_gather(jnp.asarray(pts), jnp.asarray(pidx)))
            want = np.where(pidx[:, None, :] >= P, 0.0, want)
        np.testing.assert_array_equal(got, want)
        return
    vals = rng.randn(L, 30, F).astype(np.float32)
    port = scatter.onehot_adjoint_plain if fn == "adjoint" else scatter.onehot_adjoint_ordered
    got = port(_ba_view(vals), torch.from_numpy(pidx), P).numpy()
    if ref == "pallas":
        want = ps.onehot_adjoint_pallas(jnp.asarray(vals), jnp.asarray(pidx), P, interpret=True)
    else:
        want = ps.onehot_adjoint_xla(jnp.asarray(vals), jnp.asarray(pidx), P)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)


class TestAdjointPlain:
    def test_matches_xla(self):
        vals, pidx, P = _adjoint_inputs(0)
        ref = np.asarray(ps.onehot_adjoint_xla(jnp.asarray(vals), jnp.asarray(pidx), P))
        got = scatter.onehot_adjoint_plain(torch.from_numpy(vals), torch.from_numpy(pidx), P)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)

    def test_matches_pallas_interpret(self):
        vals, pidx, P = _adjoint_inputs(1)
        ref = np.asarray(ps.onehot_adjoint_pallas(jnp.asarray(vals), jnp.asarray(pidx), P,
                                                  interpret=True))
        got = scatter.onehot_adjoint(torch.from_numpy(vals), torch.from_numpy(pidx), P)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)

    def test_semantics(self):
        """Negative and out-of-range indices add nothing, duplicates sum, every
        other element is zero."""
        vals = torch.ones((2, 3, 8))
        pidx = torch.tensor([[0, 0, 0, -1, 5, 9, 9, 2], [-1] * 8], dtype=torch.int32)
        out = scatter.onehot_adjoint_plain(vals, pidx, 6)
        want = torch.zeros((2, 3, 6))
        want[0, :, 0], want[0, :, 5], want[0, :, 2] = 3.0, 1.0, 1.0
        assert torch.equal(out, want)


class TestGatherPlain:
    def test_matches_pallas_interpret(self):
        pts, pidx = _gather_inputs(2)
        ref = np.asarray(ps.onehot_gather_pallas(jnp.asarray(pts), jnp.asarray(pidx),
                                                 interpret=True))
        got = scatter.onehot_gather(torch.from_numpy(pts), torch.from_numpy(pidx))
        np.testing.assert_array_equal(got.numpy(), ref)

    def test_matches_row_gather(self):
        pts, pidx = _gather_inputs(3, P=512, L=4, F=128)
        ref = np.asarray(ps.onehot_gather(jnp.asarray(pts), jnp.asarray(pidx)))
        got = scatter.onehot_gather_plain(torch.from_numpy(pts), torch.from_numpy(pidx))
        np.testing.assert_array_equal(got.numpy(), ref)

    def test_out_of_range_gives_zero(self):
        """The Pallas kernel's meaning: pidx >= P reads nothing."""
        pts = torch.arange(6, dtype=torch.float32).reshape(2, 3)
        pidx = torch.tensor([[0, 2, 3, -1]], dtype=torch.int32)
        out = scatter.onehot_gather_plain(pts, pidx)
        assert torch.equal(out, torch.tensor([[[0.0, 2.0, 0.0, 0.0], [3.0, 5.0, 0.0, 0.0]]]))


class TestDispatch:
    def test_use_kernel_true_on_cpu_raises(self):
        vals, pidx, P = _adjoint_inputs(4, L=2, F=48, P=32)
        with pytest.raises(ValueError, match="CUDA"):
            scatter.onehot_adjoint(torch.from_numpy(vals), torch.from_numpy(pidx), P,
                                   use_kernel=True)
        pts, gidx = _gather_inputs(4, P=32, L=2, F=16)
        with pytest.raises(ValueError, match="CUDA"):
            scatter.onehot_gather(torch.from_numpy(pts), torch.from_numpy(gidx), use_kernel=True)

    def test_kernel_wrappers_take_cuda_tensors_only(self):
        """The wrappers never fall back: a CPU tensor raises before any build
        or launch, and the launch counters stay put."""
        before = (profiling.counter("k2.launches"), profiling.counter("k3.launches"))
        vals, pidx, P = _adjoint_inputs(5, L=2, F=48, P=32)
        with pytest.raises(ValueError, match="CUDA"):
            scatter_kernel.onehot_adjoint(torch.from_numpy(vals), torch.from_numpy(pidx), P)
        pts, gidx = _gather_inputs(5, P=32, L=2, F=16)
        with pytest.raises(ValueError, match="CUDA"):
            scatter_kernel.onehot_gather(torch.from_numpy(pts), torch.from_numpy(gidx))
        assert (profiling.counter("k2.launches"), profiling.counter("k3.launches")) == before


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(5, 30, 130, 260), (20, 30, 512, 4096), (32, 30, 512, 4096)])
def test_adjoint_kernel_matches_plain_on_card(shape):
    """K2 against its plain version on the card, on the [L,G,F] view that
    `bundle_adjust` passes: max|diff| <= 1e-5 (1 + max|ref|), the
    ascending-f sum against cuBLAS's order."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the K2 kernel has no CPU mode")
    L, G, F, P = shape
    vals, pidx, _ = _adjoint_inputs(6, L, G, F, P)
    dev = torch.device("cuda")
    v, i = _ba_view(vals).to(dev), torch.from_numpy(pidx).to(dev)
    before = profiling.counter("k2.launches")
    got = scatter_kernel.onehot_adjoint(v, i, P)
    ref = scatter.onehot_adjoint_plain(v, i, P)
    torch.cuda.synchronize()
    assert profiling.counter("k2.launches") == before + 1
    bound = 1e-5 * (1.0 + float(ref.abs().max()))
    assert float((got - ref).abs().max()) <= bound


@pytest.mark.cuda
@pytest.mark.parametrize("index_set", ADVERSARIAL)
def test_adjoint_kernel_is_the_ascending_sum_on_card(index_set):
    """K2 at the System's BA shapes (L=32, G=30, F=512, P=4096) equals
    itself on a second run and, bit for bit, the ascending-f sum; within
    1e-5 (1 + max|ref|) of its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the K2 kernel has no CPU mode")
    L, G, F, P = 32, 30, 512, 4096
    pidx = _adversarial_pidx(index_set, L, F, P)
    vals = np.random.RandomState(13).randn(L, G, F).astype(np.float32)
    dev = torch.device("cuda")
    v, i = _ba_view(vals).to(dev), torch.from_numpy(pidx).to(dev)
    a, b = scatter_kernel.onehot_adjoint(v, i, P), scatter_kernel.onehot_adjoint(v, i, P)
    ordered = scatter.onehot_adjoint_ordered(v, i, P)
    ref = scatter.onehot_adjoint_plain(v, i, P)
    torch.cuda.synchronize()
    assert torch.equal(a, b) and torch.equal(a, ordered)
    assert float((a - ref).abs().max()) <= 1e-5 * (1.0 + float(ref.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 260, 5, 130), (3, 4096, 20, 512), (3, 4096, 32, 512),
                                   (3, 4096, 32, 510)])
def test_gather_kernel_matches_plain_on_card(shape):
    """K3 against its plain version on the card: bit-identical (F = 510
    takes the scalar path)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the K3 kernel has no CPU mode")
    G, P, L, F = shape
    pts, pidx = _gather_inputs(7, G, P, L, F)
    dev = torch.device("cuda")
    p, i = torch.from_numpy(pts).to(dev), torch.from_numpy(pidx).to(dev)
    got = scatter_kernel.onehot_gather(p, i)
    ref = scatter.onehot_gather_plain(p, i)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
