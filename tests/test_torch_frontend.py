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
from dvm_slam_tpu_torch.utils import profiling

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
        before = profiling.counter("k1.launches")
        ang_w, desc_w = orb_kernel.orient_and_describe(_t(img), _t(blur), _t(xy))
        ang_t, desc_t = tod.orient_and_describe(_t(img), _t(blur), _t(xy))
        assert profiling.counter("k1.launches") == before  # no kernel on the CPU
        np.testing.assert_array_equal(ang_w.numpy(), ang_t.numpy())
        np.testing.assert_array_equal(desc_w.numpy(), desc_t.numpy())


def _frame_levels(img, flat_level=2, n_levels=4, n_features=96):
    """A frame's K1 inputs as `extract` makes them, numpy in: the pyramid's
    level images and blurs, the slots `detect_level` fills on each; level
    `flat_level` keeps the slots `detect_level` leaves on a flat image, so
    none is valid. Returns (raws, blurs, xy per level)."""
    budgets = jex.FrontendConfig(height=img.shape[0], width=img.shape[1], n_features=n_features,
                                 n_levels=n_levels).level_budgets
    raws, blurs, xys = [], [], []
    for lv, (im, b) in enumerate(zip(jpyr.build_pyramid(jnp.asarray(img), n_levels, 1.2), budgets)):
        det = jnp.full_like(im, 100.0) if lv == flat_level else im
        xy, _, valid = jfast.detect_level(det, 20.0, 7.0, 35, b)
        assert bool(jnp.any(valid)) == (lv != flat_level)
        raws.append(np.asarray(im))
        blurs.append(np.asarray(jpyr.gaussian_blur(im)))
        xys.append(np.asarray(xy))
    return raws, blurs, xys


# Levels of odd sizes down to the 31 rows K1 takes; level 1 gets only the
# invalid slots of a flat image, level 3 no slot at all
ADV_SHAPES = ((97, 131), (81, 109), (57, 75), (45, 63), (31, 37))


def _adversarial_levels():
    """K1's hardest small frame from numpy seed 11: noise levels of odd
    sizes with the slots `detect_level` fills (invalid ones may lie in the
    padding past the image), then the corners, the detection border, half
    pixels (rounded to even) and points outside the image, where the moment
    centre and the BRIEF samples are clamped. Returns (raws, blurs, xy per
    level) as numpy."""
    rng = np.random.RandomState(11)
    raws, blurs, xys = [], [], []
    for lv, (h, w) in enumerate(ADV_SHAPES):
        im = (rng.rand(h, w) * 255).astype(np.float32)
        if lv == 1:
            xy = np.asarray(jfast.detect_level(jnp.full((h, w), 100.0), 20.0, 7.0, 35, 24)[0])
        elif lv == 3:
            xy = np.zeros((0, 2), np.float32)
        else:
            det = np.asarray(jfast.detect_level(jnp.asarray(im), 20.0, 7.0, 35, 40)[0])
            edge = np.array([[0, 0], [w - 1, 0], [0, h - 1], [w - 1, h - 1], [15, 15], [16, 16],
                             [w - 16, h - 16], [w - 17, h - 17], [15.5, 16.5], [16.5, 15.5],
                             [w - 16.5, h - 15.5], [w / 2 + 0.5, h / 2 - 0.5], [-3.2, -0.5],
                             [w + 20, h + 7], [w + 40, -30]], np.float32)
            xy = np.concatenate([det, edge])
        raws.append(im)
        blurs.append(np.asarray(jpyr.gaussian_blur(jnp.asarray(im))))
        xys.append(xy)
    return raws, blurs, xys


def _offsets(xys):
    return tuple(int(o) for o in np.cumsum([0] + [len(x) for x in xys]))


def _levels_to(raws, blurs, xys, dev=torch.device("cpu")):
    """The per-level numpy arrays as the K1 wrapper's arguments on `dev`."""
    return ([_t(r).to(dev) for r in raws], [_t(b).to(dev) for b in blurs],
            _t(np.concatenate(xys)).to(dev), _offsets(xys))


class TestOrbLevels:
    """The whole-frame K1 call: the plain version against the per-level twin
    and the JAX package, the wrapper on CPU tensors, and the level table."""

    @pytest.mark.parametrize("kind", ["random", "rendered", "adversarial"])
    def test_levels_twin_matches_per_level_and_jax(self, images, kind):
        """The frame's (angle, desc) are the per-level twin's, concatenated,
        exactly; against the JAX package per level, angles atol 2e-3
        (moments summed in another order) and descriptor bits identical."""
        raws, blurs, xys = _adversarial_levels() if kind == "adversarial" \
            else _frame_levels(images[kind])
        ang, desc = tod.orient_and_describe_levels(*_levels_to(raws, blurs, xys))
        offs = _offsets(xys)
        assert ang.shape == (offs[-1],) and desc.shape == (offs[-1], tod.DESC_BITS)
        for lv, (raw, blur, xy) in enumerate(zip(raws, blurs, xys)):
            a, b = offs[lv], offs[lv + 1]
            ang_t, desc_t = tod.orient_and_describe(_t(raw), _t(blur), _t(xy))
            assert torch.equal(ang[a:b], ang_t) and torch.equal(desc[a:b], desc_t)
            if b == a:
                continue
            ang_j, desc_j = jod.orient_and_describe(jnp.asarray(raw), jnp.asarray(blur),
                                                    jnp.asarray(xy))
            np.testing.assert_allclose(ang[a:b].numpy(), np.asarray(ang_j), atol=2e-3)
            np.testing.assert_array_equal(desc[a:b].numpy(), np.asarray(desc_j))

    def test_wrapper_runs_plain_levels_on_cpu(self, images):
        args = _levels_to(*_frame_levels(images["random"]))
        before = profiling.counter("k1.launches")
        ang_w, desc_w = orb_kernel.orient_and_describe_levels(*args)
        ang_p, desc_p = tod.orient_and_describe_levels(*args)
        assert profiling.counter("k1.launches") == before  # no kernel on the CPU
        assert torch.equal(ang_w, ang_p) and torch.equal(desc_w, desc_p)

    def test_level_table_layout(self, images):
        """Raw pointers, blurred pointers, heights, widths, then offsets."""
        raws, blurs, xy, offs = _levels_to(*_frame_levels(images["random"]))
        table = list(orb_kernel.level_table(raws, blurs, xy, offs))
        n = len(raws)
        assert table[:n] == [r.data_ptr() for r in raws]
        assert table[n:2 * n] == [b.data_ptr() for b in blurs]
        assert table[2 * n:4 * n] == [r.shape[0] for r in raws] + [r.shape[1] for r in raws]
        assert table[4 * n:] == list(offs)

    def test_level_table_takes_sixteen_levels(self):
        im = torch.zeros((31, 33))
        xy = torch.zeros((16, 2))
        table = orb_kernel.level_table([im] * 16, [im] * 16, xy, tuple(range(17)))
        assert len(table) == 5 * 16 + 1

    def test_level_table_takes_sixty_four_levels(self):
        """Eight frames of eight levels, `extract_batch`'s table."""
        im = torch.zeros((31, 33))
        xy = torch.zeros((64, 2))
        table = orb_kernel.level_table([im] * 64, [im] * 64, xy, tuple(range(65)))
        assert len(table) == 5 * 64 + 1

    @pytest.mark.parametrize("bad, error, match", [
        ("65 levels", ValueError, "1 to 64 levels"),
        ("no level", ValueError, "1 to 64 levels"),
        ("fewer blurs", ValueError, "blurred levels"),
        ("offsets too short", ValueError, "offsets"),
        ("offsets from 1", ValueError, "rise from 0"),
        ("offsets past F", ValueError, "rise from 0"),
        ("falling offsets", ValueError, "rise from 0"),
        ("xy float64", TypeError, "float32 keypoints"),
        ("xy [F,3]", ValueError, r"\[F,2\]"),
        ("xy strided", ValueError, r"\[F,2\]"),
        ("image uint8", TypeError, "float32 images"),
        ("blur of another shape", ValueError, "one \\[H,W\\] shape"),
        ("image [1,H,W]", ValueError, "one \\[H,W\\] shape"),
        ("level below 31 rows", ValueError, "31x31"),
        ("image strided", ValueError, "contiguous level images"),
    ])
    def test_level_table_raises(self, images, bad, error, match):
        """What the kernel does not take raises, on the CPU path too, before
        anything runs."""
        raws, blurs, xy, offs = _levels_to(*_frame_levels(images["random"]))
        offs = list(offs)
        if bad == "65 levels":
            raws, blurs, offs = (raws * 17)[:65], (blurs * 17)[:65], [0] * 65 + [xy.shape[0]]
        elif bad == "no level":
            raws, blurs, offs = [], [], [xy.shape[0]]
        elif bad == "fewer blurs":
            blurs = blurs[:-1]
        elif bad == "offsets too short":
            offs = offs[:-1]
        elif bad == "offsets from 1":
            offs[0] = 1
        elif bad == "offsets past F":
            offs[-1] += 1
        elif bad == "falling offsets":
            offs[1], offs[2] = offs[2], offs[1]
        elif bad == "xy float64":
            xy = xy.double()
        elif bad == "xy [F,3]":
            xy = torch.cat([xy, xy[:, :1]], 1)
        elif bad == "xy strided":
            xy = xy.t().contiguous().t()
        elif bad == "image uint8":
            raws[1] = raws[1].to(torch.uint8)
        elif bad == "blur of another shape":
            blurs[2] = blurs[2][:-1].contiguous()
        elif bad == "image [1,H,W]":
            raws[0], blurs[0] = raws[0][None], blurs[0][None]
        elif bad == "level below 31 rows":
            raws[3], blurs[3] = raws[3][:30].contiguous(), blurs[3][:30].contiguous()
        elif bad == "image strided":
            raws[1] = raws[1].t().contiguous().t()
            blurs[1] = blurs[1].t().contiguous().t()
        before = profiling.counter("k1.launches")
        with pytest.raises(error, match=match):
            orb_kernel.level_table(raws, blurs, xy, offs)
        with pytest.raises(error, match=match):
            orb_kernel.orient_and_describe_levels(raws, blurs, xy, offs)
        assert profiling.counter("k1.launches") == before


@pytest.mark.cuda
def test_levels_kernel_matches_twin_on_card():
    """K1's one launch for a whole frame on the card against its twin, on
    the adversarial frame: descriptor bits identical, angles within 1e-6
    (atan2f and PyTorch's atan2 may round apart), exactly one launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the K1 kernel has no CPU mode")
    args = _levels_to(*_adversarial_levels(), dev=torch.device("cuda"))
    before = profiling.counter("k1.launches")
    ang_k, desc_k = orb_kernel.orient_and_describe_levels(*args)
    assert profiling.counter("k1.launches") == before + 1
    ang_t, desc_t = tod.orient_and_describe_levels(*args)
    torch.cuda.synchronize()
    assert float((ang_k - ang_t).abs().max()) <= 1e-6
    assert torch.equal(desc_k, desc_t)


@pytest.mark.cuda
def test_kernel_matches_twin_on_card(images):
    """K1 on the card against its twin on the same inputs: angle atol 1e-4,
    descriptor bits identical (same float operations in the same order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the K1 kernel has no CPU mode")
    img, blur, xy = _kp_inputs(images["rendered"])
    dev = torch.device("cuda")
    before = profiling.counter("k1.launches")
    ang_k, desc_k = orb_kernel.orient_and_describe(_t(img).to(dev), _t(blur).to(dev), _t(xy).to(dev))
    ang_t, desc_t = tod.orient_and_describe(_t(img).to(dev), _t(blur).to(dev), _t(xy).to(dev))
    torch.cuda.synchronize()
    assert profiling.counter("k1.launches") == before + 1
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

    @pytest.mark.parametrize("use_kernel", [None, False])
    def test_extract_is_the_per_level_assembly(self, images, use_kernel):
        """One K1 call for the frame gives the Frame that describing each
        level on its own and concatenating gives, every field identical,
        through the wrapper (None) and the plain version (False)."""
        tfc = tex.FrontendConfig(height=H, width=W, n_features=96, n_levels=4,
                                 use_kernel=use_kernel)
        assert tfc.level_offsets == tuple(np.cumsum([0, *tfc.level_budgets]))
        assert tfc.level_offsets[-1] == tfc.capacity
        img = _t(images["rendered"])
        got = tex.extract(img, tfc)
        parts = []
        for lv, (im, b, s) in enumerate(zip(tpyr.build_pyramid(img, 4, 1.2), tfc.level_budgets,
                                            tfc.scales)):
            xy, score, valid = tfast.detect_level(im, 20.0, 7.0, 35, b)
            ang, desc = tod.orient_and_describe(im, tpyr.gaussian_blur(im), xy)
            parts.append((xy * s, torch.full((b,), lv, dtype=torch.int32), ang, score, desc, valid))
        for name, want in zip(("xy", "level", "angle", "response", "desc", "valid"),
                              (torch.cat(c) for c in zip(*parts))):
            assert torch.equal(getattr(got, name), want), name
        assert torch.equal(got.xy_raw, got.xy)

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
