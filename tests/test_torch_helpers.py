"""The public helpers no path calls (`ops/image.py`: `to_gray`, `sobel`,
`extract_patches`; `geometry/se3.py`: `DEG2RAD`, `RAD2DEG`,
`decompose_transform`, `motion_absolute_error`) against the JAX
package's, on seeded numpy inputs.  Stated tolerances: `to_gray` and
`sobel` within 1e-5 relative, `extract_patches` exactly (keypoints at all
four borders and beyond them, half-pixel positions rounding to even),
`decompose_transform` within 1e-6, `motion_absolute_error` within 1e-4
degrees and 1e-6 in translation."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from front_end_tpu.geometry import se3 as jse3
from front_end_tpu.ops import image as jimage
from front_end_tpu_torch.geometry import se3 as tse3
from front_end_tpu_torch.ops import image as timage
from torch_parity import image, n, t


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_to_gray_matches_jax(dtype):
    rs = np.random.RandomState(0)
    rgb = rs.uniform(0, 255, (2, 17, 23, 3)).astype(dtype)
    got = timage.to_gray(rgb)
    assert got.dtype == torch.float32 and got.shape == (2, 17, 23)
    np.testing.assert_allclose(n(got), n(jimage.to_gray(rgb)), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_sobel_matches_jax(seed):
    img = image(40, 56, seed=seed) + np.random.RandomState(seed).uniform(
        0, 1, (40, 56)).astype(np.float32)
    for g, j in zip(timage.sobel(t(img)), jimage.sobel(jnp.asarray(img))):
        np.testing.assert_allclose(n(g), n(j), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("patch", [5, 8, 31])
def test_extract_patches_equal_jax(patch):
    H, W = 48, 64
    img = np.random.RandomState(patch).uniform(0, 255, (H, W)) \
        .astype(np.float32)
    rs = np.random.RandomState(7)
    inside = rs.uniform(0, [W - 1, H - 1], (20, 2))
    borders = [(0, 20), (W - 1, 20), (30, 0), (30, H - 1), (0, 0),
               (W - 1, H - 1), (-5.0, -3.0), (W + 4.0, H + 9.0),
               (2.5, 3.5), (12.5, 13.5), (W - 1.5, H - 0.5)]
    xy = np.concatenate([inside, borders]).astype(np.float32)
    got = timage.extract_patches(t(img), t(xy), patch)
    want = jimage.extract_patches(jnp.asarray(img), jnp.asarray(xy), patch)
    assert got.shape == (len(xy), patch, patch)
    np.testing.assert_array_equal(n(got), n(want))


def _motion(seed, batch):
    rs = np.random.RandomState(seed)
    return (rs.uniform(-np.pi, np.pi, (batch, 3)).astype(np.float32),
            rs.uniform(-5, 5, (batch, 3)).astype(np.float32))


def _transforms(ang, T):
    R = jse3.euler_matrix(ang[:, 0], ang[:, 1], ang[:, 2])
    return np.asarray(jse3.create_homog(R, jnp.asarray(T)))


@pytest.mark.parametrize("batched", [False, True])
def test_decompose_transform_matches_jax(batched):
    H = _transforms(*_motion(3, 6))
    H = H if batched else H[0]
    got = tse3.decompose_transform(t(H))
    np.testing.assert_allclose(n(got), n(jse3.decompose_transform(H)),
                               atol=1e-6)


def test_motion_absolute_error_matches_jax():
    ang, T = _motion(4, 16)
    far = _motion(5, 8)                  # half the pairs near, half far
    H = _transforms(ang, T)
    H_est = _transforms(np.concatenate([ang[:8] + 1e-3, far[0]]),
                        np.concatenate([T[:8] + 1e-3, far[1]]))
    ga, gt = tse3.motion_absolute_error(t(H), t(H_est))
    ja, jt = jse3.motion_absolute_error(jnp.asarray(H), jnp.asarray(H_est))
    np.testing.assert_allclose(n(ga), n(ja), atol=1e-4)
    np.testing.assert_allclose(n(gt), n(jt), atol=1e-6)


def test_degree_constants_equal_jax():
    assert np.float32(tse3.DEG2RAD) == np.float32(jse3.DEG2RAD)
    assert np.float32(tse3.RAD2DEG) == np.float32(jse3.RAD2DEG)
