"""Parity of the port's front end with the JAX package: the pyramid resize
and blur, FAST detection, the K1 twin (orientation + steered BRIEF) and
`make_frame` / `make_frame_rgbd`, at the flagship entry's small size (96x128,
96 features, 4 levels) on numpy-seeded and rendered images. The K1 CUDA kernel
itself runs only on a card (`cuda` marker)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax._src.image.scale import _fill_triangle_kernel, compute_weight_mat

from dvm_slam_tpu.frontend import extractor as jex
from dvm_slam_tpu.io import synthetic as jsyn
from dvm_slam_tpu.ops import fast as jfast
from dvm_slam_tpu.ops import orb_descriptor as jod
from dvm_slam_tpu.ops import pallas_orb
from dvm_slam_tpu.ops import pyramid as jpyr
from dvm_slam_tpu.ops import stereo as jst

from dvm_slam_tpu_torch.frontend import extractor as tex
from dvm_slam_tpu_torch.ops import fast as tfast
from dvm_slam_tpu_torch.ops import orb_descriptor as tod
from dvm_slam_tpu_torch.ops import orb_kernel
from dvm_slam_tpu_torch.ops import pyramid as tpyr
from dvm_slam_tpu_torch.ops import stereo as tst

torch.set_num_threads(2)

H, W = 96, 128
K = np.array([100.0, 100.0, W / 2, H / 2], np.float32)
# level images: f32 matmuls summed in another order than XLA's einsum, a few
# ulps of a 0..255 grey level
LEVEL_ATOL = 1e-3


def _random_img(seed=0, h=H, w=W):
    return np.random.RandomState(seed).rand(h, w).astype(np.float32) * 255


def _rendered_img():
    world = jsyn.PlaneWorld(seed=7, tex_size=256, plane_z=6.0, extent=36.0)
    pose = jnp.asarray([1.0, 0, 0, 0, 0, 0, 0], jnp.float32)
    return np.asarray(world.render(pose, jnp.asarray(K), H, W))


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def images():
    return {"random": _random_img(), "rendered": _rendered_img()}


class TestPyramid:
    @pytest.mark.parametrize("n_in,n_out", [(128, 107), (96, 80), (752, 627), (8, 256), (16, 96)])
    def test_resize_weights_match_jax(self, n_in, n_out):
        """Down (antialiased triangle) and up: the weight matrices of JAX's
        `scale_and_translate`, to f32 rounding of the column sums."""
        want = np.asarray(compute_weight_mat(n_in, n_out, n_out / n_in, 0.0,
                                             _fill_triangle_kernel, True))
        np.testing.assert_allclose(tpyr.resize_weights(n_in, n_out), want, atol=1e-6)

    @pytest.mark.parametrize("shape", [(80, 107), (64, 64), (200, 300)])
    def test_resize_matches_jax(self, shape):
        img = _random_img(1, 96, 128)
        want = np.asarray(jax.image.resize(jnp.asarray(img), shape, "linear"))
        got = tpyr.resize(_t(img), *shape).numpy()
        np.testing.assert_allclose(got, want, atol=LEVEL_ATOL)

    def test_levels_match_jax(self, images):
        for img in images.values():
            want = jpyr.build_pyramid(jnp.asarray(img), 4, 1.2)
            got = tpyr.build_pyramid(_t(img), 4, 1.2)
            assert [tuple(g.shape) for g in got] == [w.shape for w in want]
            for g, w in zip(got, want):
                np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=LEVEL_ATOL)

    def test_blur_matches_jax(self, images):
        for img in images.values():
            np.testing.assert_allclose(tpyr.gaussian_blur(_t(img)).numpy(),
                                       np.asarray(jpyr.gaussian_blur(jnp.asarray(img))),
                                       atol=LEVEL_ATOL)

    def test_level_shapes_match_jax(self):
        assert tpyr.level_shapes(480, 752, 8, 1.2) == jpyr.level_shapes(480, 752, 8, 1.2)


class TestFast:
    @pytest.mark.parametrize("kind", ["random", "rendered"])
    def test_detect_level_identical(self, images, kind):
        """Same image in: xy, score and valid identical on every level
        (stable-sort tie order, the fused f32 selection key)."""
        levels = jpyr.build_pyramid(jnp.asarray(images[kind]), 4, 1.2)
        budgets = jex.FrontendConfig(height=H, width=W, n_features=96, n_levels=4).level_budgets
        for lv, b in zip(levels, budgets):
            want = jfast.detect_level(lv, 20.0, 7.0, 35, b)
            got = tfast.detect_level(_t(lv), 20.0, 7.0, 35, b)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))

    def test_fast_response_identical(self, images):
        img = images["rendered"]
        for th in (7.0, 20.0):
            np.testing.assert_array_equal(tfast.fast_response(_t(img), th).numpy(),
                                          np.asarray(jfast.fast_response(jnp.asarray(img), th)))


def _kp_inputs(img, n_features=96):
    """A level image, its blur and the keypoints detect_level picks (valid
    ones first, then the invalid slots it also returns)."""
    blur = np.asarray(jpyr.gaussian_blur(jnp.asarray(img)))
    xy, _, valid = jfast.detect_level(jnp.asarray(img), 20.0, 7.0, 35, n_features)
    xy, valid = np.asarray(xy), np.asarray(valid)
    return img, blur, np.concatenate([xy[valid], xy[~valid]])


class TestOrbTwin:
    @pytest.mark.parametrize("kind", ["random", "rendered"])
    def test_twin_matches_xla_path(self, images, kind):
        """Angle atol 2e-3 (moments summed in another order); descriptor bits
        identical."""
        img, blur, xy = _kp_inputs(images[kind])
        ang_j, desc_j = jod.orient_and_describe(jnp.asarray(img), jnp.asarray(blur), jnp.asarray(xy))
        ang_t, desc_t = tod.orient_and_describe(_t(img), _t(blur), _t(xy))
        np.testing.assert_allclose(ang_t.numpy(), np.asarray(ang_j), atol=2e-3)
        np.testing.assert_array_equal(desc_t.numpy(), np.asarray(desc_j))

    def test_twin_matches_pallas_interpret(self, images):
        """Against the TPU kernel in interpret mode, on valid keypoints (the
        Pallas wrapper also clamps the BRIEF centre, which moves only invalid
        slots): angle atol 2e-3, under 1% of bits differing, the bound of the
        Pallas kernel's own test."""
        img, blur, xy = _kp_inputs(images["random"])
        xy = xy[(xy[:, 0] >= 16) & (xy[:, 0] < W - 16) & (xy[:, 1] >= 16) & (xy[:, 1] < H - 16)]
        assert len(xy) >= 20
        ang_p, desc_p = pallas_orb.orient_and_describe(jnp.asarray(img), jnp.asarray(blur),
                                                       jnp.asarray(xy), interpret=True)
        ang_t, desc_t = tod.orient_and_describe(_t(img), _t(blur), _t(xy))
        np.testing.assert_allclose(ang_t.numpy(), np.asarray(ang_p), atol=2e-3)
        assert float((desc_t.numpy() != np.asarray(desc_p)).mean()) < 0.01

    def test_moments_and_clamped_centres(self):
        """Keypoints at the image corners: moments clamp the centre, BRIEF
        clamps each sample, as the XLA path does."""
        img = _random_img(4)
        blur = np.asarray(jpyr.gaussian_blur(jnp.asarray(img)))
        xy = np.array([[0.0, 0.0], [127.0, 95.0], [64.0, 48.0], [15.5, 16.5]], np.float32)
        m01_j, m10_j = jod.moments(jnp.asarray(img), jnp.asarray(xy))
        m01_t, m10_t = tod.moments(_t(img), _t(xy))
        # f32 sums of ~700 terms of magnitude up to 255*15, in another order
        np.testing.assert_allclose(m01_t.numpy(), np.asarray(m01_j), atol=1.0)
        np.testing.assert_allclose(m10_t.numpy(), np.asarray(m10_j), atol=1.0)
        _, desc_j = jod.orient_and_describe(jnp.asarray(img), jnp.asarray(blur), jnp.asarray(xy))
        _, desc_t = tod.orient_and_describe(_t(img), _t(blur), _t(xy))
        np.testing.assert_array_equal(desc_t.numpy(), np.asarray(desc_j))

    def test_thread_tree_sum_is_a_sum(self):
        """The kernel-order sum equals the plain sum to f32 rounding."""
        x = torch.from_numpy(np.random.RandomState(5).randn(7, 961).astype(np.float32))
        np.testing.assert_allclose(tod._thread_tree_sum(x).numpy(),
                                   x.double().sum(-1).numpy(), rtol=1e-5, atol=1e-4)

    def test_pattern_and_mask_identical(self):
        np.testing.assert_array_equal(tod.PATTERN, jod.PATTERN)
        np.testing.assert_array_equal(tod._CIRC_MASK, jod._CIRC_MASK)

    def test_wrapper_runs_twin_on_cpu(self, images):
        img, blur, xy = _kp_inputs(images["random"])
        before = orb_kernel.launches
        ang_w, desc_w = orb_kernel.orient_and_describe(_t(img), _t(blur), _t(xy))
        ang_t, desc_t = tod.orient_and_describe(_t(img), _t(blur), _t(xy))
        assert orb_kernel.launches == before  # no kernel on the CPU
        np.testing.assert_array_equal(ang_w.numpy(), ang_t.numpy())
        np.testing.assert_array_equal(desc_w.numpy(), desc_t.numpy())


@pytest.mark.cuda
def test_kernel_matches_twin_on_card(images):
    """K1 on the card against its twin on the same inputs: angle atol 1e-4,
    descriptor bits identical (same float operations in the same order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the K1 kernel has no CPU mode")
    img, blur, xy = _kp_inputs(images["rendered"])
    dev = torch.device("cuda")
    before = orb_kernel.launches
    ang_k, desc_k = orb_kernel.orient_and_describe(_t(img).to(dev), _t(blur).to(dev), _t(xy).to(dev))
    ang_t, desc_t = tod.orient_and_describe(_t(img).to(dev), _t(blur).to(dev), _t(xy).to(dev))
    torch.cuda.synchronize()
    assert orb_kernel.launches == before + 1
    np.testing.assert_allclose(ang_k.cpu().numpy(), ang_t.cpu().numpy(), atol=1e-4)
    np.testing.assert_array_equal(desc_k.cpu().numpy(), desc_t.cpu().numpy())


def _frame_fields_equal(got, want):
    """Frame field by field: integer and bool fields identical, descriptors
    identical, keypoints to 1e-4 px, angles to 2e-3 rad, responses to 1e-3
    (FAST sums of level pixels that differ by ulps)."""
    for name in ("level", "valid", "desc", "xy_raw"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                      err_msg=name)
    np.testing.assert_allclose(got.xy.numpy(), np.asarray(want.xy), atol=1e-4)
    np.testing.assert_allclose(got.angle.numpy(), np.asarray(want.angle), atol=2e-3)
    np.testing.assert_allclose(got.response.numpy(), np.asarray(want.response), atol=1e-3)


class TestMakeFrame:
    @pytest.mark.parametrize("kind", ["random", "rendered"])
    def test_make_frame_field_by_field(self, images, kind):
        fc = jex.FrontendConfig(height=H, width=W, n_features=96, n_levels=4)
        tfc = tex.FrontendConfig(height=H, width=W, n_features=96, n_levels=4)
        dist = np.array([-0.05, 0.01, 0.001, -0.001], np.float32)
        want = jex.make_frame(jnp.asarray(images[kind]), jnp.asarray(K), jnp.asarray(dist), fc)
        got = tex.make_frame(_t(images[kind]), _t(K), _t(dist), tfc)
        assert got.ur is None and got.depth is None
        _frame_fields_equal(got, want)

    def test_make_frame_rgbd_field_by_field(self, images):
        fc = jex.FrontendConfig(height=H, width=W, n_features=96, n_levels=4)
        tfc = tex.FrontendConfig(height=H, width=W, n_features=96, n_levels=4)
        depth = np.random.RandomState(2).rand(H, W).astype(np.float32) * 5
        depth[::7] = 0.0  # holes
        want = jex.make_frame_rgbd(jnp.asarray(images["rendered"]), jnp.asarray(depth),
                                   jnp.asarray(K), jnp.zeros(4), fc, jnp.float32(8.0))
        got = tex.make_frame_rgbd(_t(images["rendered"]), _t(depth), _t(K), torch.zeros(4), tfc, 8.0)
        _frame_fields_equal(got, want)
        np.testing.assert_allclose(got.depth.numpy(), np.asarray(want.depth), atol=1e-6)
        np.testing.assert_allclose(got.ur.numpy(), np.asarray(want.ur), atol=1e-4)

    def test_stereo_from_rgbd_matches_jax(self):
        rng = np.random.RandomState(9)
        xy = (rng.rand(50, 2) * [W, H]).astype(np.float32)
        valid = rng.rand(50) > 0.2
        depth = rng.rand(H, W).astype(np.float32) * 4
        depth[rng.rand(H, W) > 0.7] = 0.0
        want = jst.compute_stereo_from_rgbd(jnp.asarray(xy), jnp.asarray(valid), jnp.asarray(depth),
                                            jnp.float32(40.0), jnp.float32(0.5))
        got = tst.compute_stereo_from_rgbd(_t(xy), _t(valid), _t(depth), 40.0, 0.5)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)
