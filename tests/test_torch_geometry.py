"""The port's OpenCV-free host geometry against the JAX package's cv2-based
functions (cv2 is installed where the tests run).

Bounds: rasterisation and contours follow OpenCV's integer algorithms and
must agree exactly (the contour bar is the looser count/order/IoU >= 0.99);
minAreaRect is followed in f32, so the rotation angle must agree within
1e-3 degrees and the long-side ratio within 1e-4 (relative); warp and resize
produce uint8 through OpenCV's own fixed point or vectorised rounding, so
they must agree within one gray level on every pixel and exactly on >= 99 %.
"""
import numpy as np
import pytest
from scipy import ndimage

from adascale.data import geometry as JG
from adascale.inference import eval as JE
from adascale.inference import flatten as JF
from adascale_torch.data import geometry as TG
from adascale_torch.inference import eval as TE
from adascale_torch.inference import flatten as TF

cv2 = pytest.importorskip("cv2")


def _polygons(rng, n, concave):
    for _ in range(n):
        k = int(rng.integers(3, 12))
        ang = np.sort(rng.uniform(0, 2 * np.pi, k))
        r = rng.uniform(3, 30) * (rng.uniform(0.3, 1.0, k) if concave else 1.0)
        c = rng.uniform(-10, 70, 2)
        yield np.stack([c[0] + r * np.cos(ang), c[1] + r * np.sin(ang)], axis=1)


@pytest.mark.parametrize("concave", [False, True])
def test_fill_mask_equals_cv2(concave):
    rng = np.random.default_rng(int(concave))
    for pts in _polygons(rng, 300, concave):
        shape = tuple(int(v) for v in rng.integers(5, 60, 2))
        want = JG.Polygon(pts).fill_mask(shape)
        got = TG.Polygon(pts).fill_mask(shape)
        np.testing.assert_array_equal(got, want, err_msg=str(pts.tolist()))


def _blob_mask(rng):
    h, w = (int(v) for v in rng.integers(8, 90, 2))
    m = rng.random((h, w)) < rng.uniform(0.05, 0.5)
    m = ndimage.binary_dilation(m, iterations=int(rng.integers(0, 3)) or 1)
    return ndimage.binary_opening(m).astype(np.uint8) if rng.random() < 0.3 else m.astype(np.uint8)


def test_mask_to_disconnected_polygons_matches_cv2():
    rng = np.random.default_rng(0)
    for _ in range(150):
        mask = _blob_mask(rng)
        want = JG.mask_to_disconnected_polygons(mask)
        got = TG.mask_to_disconnected_polygons(mask)
        assert len(got) == len(want)
        for g, w in zip(got, want):  # same order
            a = g.fill_mask(mask.shape).astype(bool)
            b = w.fill_mask(mask.shape).astype(bool)
            assert (a & b).sum() / max((a | b).sum(), 1) >= 0.99


def test_nested_component_is_not_external():
    mask = np.zeros((12, 12), np.uint8)
    mask[2:10, 2:10] = 1
    mask[3:9, 3:9] = 0
    mask[5:7, 5:7] = 1
    assert len(TG.mask_to_disconnected_polygons(mask)) == 1
    assert len(JG.mask_to_disconnected_polygons(mask)) == 1


def test_long_side_angle_matches_min_area_rect():
    rng = np.random.default_rng(0)
    for i in range(400):
        n = int(rng.integers(3, 14))
        theta = np.radians(rng.uniform(-180, 180))
        rot = np.array([[np.cos(theta), np.sin(theta)], [-np.sin(theta), np.cos(theta)]])
        length = rng.uniform(5, 60)
        pts = rng.uniform(0, 100, 2) + np.stack(
            [rng.uniform(-length, length, n), rng.uniform(-length / 4, length / 4, n)], 1
        ) @ rot
        if i % 2:
            pts = np.round(pts)
        want = JF._long_side_angle(JG.Polygon(pts))
        got = TF._long_side_angle(TG.Polygon(pts))
        d = abs(got[0] - want[0])
        assert min(d, 180 - d) <= 1e-3, (pts.tolist(), got, want)
        assert abs(got[1] - want[1]) <= 1e-4 * want[1], (got, want)


def test_rotation_matrix_and_shape():
    for angle in (-89.0, -30.5, 0.0, 12.25, 45.0, 90.0):
        for shape in ((10, 40), (37, 13)):
            np.testing.assert_allclose(
                TG.rotate_trans_mat(angle, shape), JG.rotate_trans_mat(angle, shape), atol=1e-4
            )
            assert TG.rotated_shape(angle, shape) == JG.rotated_shape(angle, shape)


def _assert_u8_close(got, want):
    assert got.shape == want.shape and got.dtype == np.uint8
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1
    assert (diff == 0).mean() >= 0.99


def test_warp_affine_matches_cv2():
    rng = np.random.default_rng(0)
    for _ in range(60):
        h, w = (int(v) for v in rng.integers(5, 70, 2))
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        angle = float(rng.uniform(-89, 89))
        mat = JG.rotate_trans_mat(angle, (h, w))
        nh, nw = JG.rotated_shape(angle, (h, w))
        _assert_u8_close(TF.warp_affine(img, mat, (nw, nh)), cv2.warpAffine(img, mat, (nw, nh)))
        mask = np.zeros((h, w), np.uint8)
        mask[h // 4 : 3 * h // 4, w // 5 :] = 1
        _assert_u8_close(TF.warp_affine(mask, mat, (nw, nh)), cv2.warpAffine(mask, mat, (nw, nh)))


@pytest.mark.parametrize(
    "mode,fn,scales",
    [
        ("area", "resize_area", (0.2, 0.99)),
        ("linear", "resize_linear", (1.0, 3.0)),
        ("nearest", "resize_nearest", (0.2, 3.0)),
    ],
)
def test_resize_matches_cv2(mode, fn, scales):
    interp = {"area": cv2.INTER_AREA, "linear": cv2.INTER_LINEAR, "nearest": cv2.INTER_NEAREST}[mode]
    rng = np.random.default_rng(1)
    for _ in range(60):
        h, w = (int(v) for v in rng.integers(3, 100, 2))
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        s = rng.uniform(*scales)
        oh, ow = max(1, round(h * s)), max(1, round(w * s))
        want = cv2.resize(img, (ow, oh), interpolation=interp)
        _assert_u8_close(getattr(TF, fn)(img, (oh, ow)), want)


def test_polygon_iou_and_matching_equal_jax():
    rng = np.random.default_rng(2)
    polys = [p for p in _polygons(rng, 60, False)]
    ours = [TG.Polygon(p) for p in polys]
    theirs = [JG.Polygon(p) for p in polys]
    for i in range(0, 60, 2):
        assert TE.polygon_iou(ours[i], ours[i + 1]) == JE.polygon_iou(theirs[i], theirs[i + 1])
    shifted = [TG.Polygon(p + 1.5) for p in polys]
    assert TE.match_polygons(shifted, ours) == JE.match_polygons(
        [JG.Polygon(p.points) for p in shifted], theirs
    )


def test_distance_transform_follows_cv2():
    """The chamfer twin of ``cv2.distanceTransform(m, cv2.DIST_L2, 3)``.
    Zeros and pixels with no zero pixel anywhere (FLT_MAX) agree exactly;
    elsewhere the twin takes OpenCV's two passes in f32 in raster order,
    while a cv2 built with Intel IPP (as its wheels are) runs IPP's
    vectorised routine, whose f32 sums take another order: where two paths
    of equal length are summed in different orders the results differ by a
    few ulps (measured <= 1.3e-6 relative on crops up to 80 x 700), so the
    rest is held to 4e-6. Along a 2000-pixel row from one zero the
    differences add up (1.6e-5 in the rows below it); the row itself, a
    chain of straight steps, is exact."""
    rng = np.random.default_rng(5)
    masks = [np.zeros((7, 9), np.uint8), np.ones((7, 9), np.uint8), np.ones((1, 1), np.uint8)]
    for _ in range(80):
        h, w = int(rng.integers(1, 60)), int(rng.integers(1, 300))
        masks.append((rng.random((h, w)) < rng.uniform(0.3, 1.0)).astype(np.uint8))
    for m in masks:
        want = cv2.distanceTransform(m, cv2.DIST_L2, 3)
        got = TG.distance_transform_l2_3x3(m)
        assert got.dtype == np.float32 and got.shape == want.shape
        for special in (0.0, np.finfo(np.float32).max):
            np.testing.assert_array_equal(got == special, want == special)
        np.testing.assert_allclose(got, want, rtol=4e-6, atol=0)
    line = np.ones((3, 2000), np.uint8)
    line[0, 0] = 0
    got, want = TG.distance_transform_l2_3x3(line), cv2.distanceTransform(line, cv2.DIST_L2, 3)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=0)
