"""The port's D2-Net against the JAX package's.

The JAX package's ``init_params`` go through ``d2net_from_jax_params``;
the ``model`` dict of ``d2_tf.pth`` gives the same net, and the JAX
converter reads it into params that give the same features. Images are
RGB from a seed.

Tolerances, measured at these sizes: the dense features at 1e-5 of their
scale (measured 7.8e-7 of 786 at 64x96); the detections (which cell and
channel, so the slots' order) equal; the sub-pixel keypoints within 1e-5
of the image width (measured 3.4e-5 px); scores (raw feature values) at
1e-5 of their scale; descriptors atol 1e-5. The detection decides on exact
values (``f == max``, ``tr^2 / det <= thr``), so a detection tied in
float64 could flip between the packages: the tests count the slots whose
detection differs, and find none at these seeds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs_localization_tpu.sfm import d2net as jd2
from gs_localization_torch.sfm import d2net as td2
from gs_localization_torch.sfm import registry as treg

REL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    return jax.tree_util.tree_map(
        np.asarray, jd2.init_params(np.random.default_rng(0)))


@pytest.fixture(scope="module")
def net(params):
    return td2.d2net_from_jax_params(params, "cpu")


def _image(seed, h=64, w=96):
    return np.random.default_rng(seed).uniform(0, 1, (h, w, 3)).astype(
        np.float32)


def _same_features(ft, fj, width):
    """Returns the count of slots whose detection differs (0 expected)."""
    kj, kt = np.asarray(fj.keypoints), ft.keypoints.numpy()
    sj = np.asarray(fj.scores)
    differ = np.abs(kt - kj).max(1) > REL * width
    assert int(differ.sum()) == 0, f"{int(differ.sum())} detections differ"
    np.testing.assert_array_equal(ft.scores.numpy() > 0, sj > 0)
    np.testing.assert_allclose(ft.scores.numpy(), sj, rtol=0,
                               atol=REL * np.abs(sj).max())
    np.testing.assert_allclose(ft.descriptors.numpy(),
                               np.asarray(fj.descriptors), rtol=0, atol=REL)
    return int((sj > 0).sum())


def test_dense_features_match_jax(params, net):
    img = _image(1)
    fj = np.asarray(jax.jit(jd2.dense_features)(params, jnp.asarray(img)))
    ft = td2.dense_features(net, torch.tensor(img)).numpy()
    assert ft.shape == (15, 23, 512)      # the 2x2 / 1 pool drops a row
    np.testing.assert_allclose(ft, fj, rtol=0, atol=REL * np.abs(fj).max())


def test_detection_and_localization_match_jax():
    """The per-channel stencils (shifted adds here, a depthwise conv in
    JAX) on one map: the detection masks are equal; the displacements of
    the detected entries agree within 1e-5."""
    rng = np.random.default_rng(2)
    f = np.maximum(rng.standard_normal((12, 16, 32)), 0).astype(np.float32)
    mj = np.asarray(jax.jit(jd2.hard_detection)(f))
    dj = np.asarray(jax.jit(jd2.localization)(f))
    mt = td2.hard_detection(torch.tensor(f)).numpy()
    dt = td2.localization(torch.tensor(f)).numpy()
    assert mj.sum() > 10
    np.testing.assert_array_equal(mt, mj)
    np.testing.assert_allclose(dt[mj], dj[mj], rtol=0, atol=REL)


@pytest.mark.parametrize("seed,hw,k", [(3, (64, 96), 256), (4, (48, 64), 64)])
def test_extract_d2net_matches_jax(params, net, seed, hw, k):
    img = _image(seed, *hw)
    fj = jd2.extract_d2net(params, jnp.asarray(img), num_keypoints=k)
    ft = td2.extract_d2net(net, torch.tensor(img), num_keypoints=k)
    assert ft.keypoints.shape == (k, 2)
    assert _same_features(ft, fj, hw[1]) > 0


def test_official_state_dict_matches_jax_params_route(net):
    img = _image(5)
    sd = {k: v.clone() for k, v in net.state_dict().items()}
    assert sorted({int(k.split(".")[2]) for k in sd}) == \
        list(td2.TORCH_CONV_IDX)
    loaded = td2.load_d2net(sd, "cpu")
    ft = td2.extract_d2net(loaded, torch.tensor(img), num_keypoints=128)
    ref = td2.extract_d2net(net, torch.tensor(img), num_keypoints=128)
    for a, b in zip(ft[:3], ref[:3]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    conv = jd2.convert_torch_weights_d2net(
        {k: v.numpy() for k, v in sd.items()})
    fj = jd2.extract_d2net(conv, jnp.asarray(img), num_keypoints=128)
    _same_features(ft, fj, img.shape[1])


def test_registry_conf_is_extract_d2net(net):
    """d2net-ss on a grayscale image is extract_d2net on it stacked to RGB."""
    gray = _image(6)[..., 0]
    f = treg.get_extractor("d2net-ss", params=net, num_keypoints=64)(gray)
    ref = td2.extract_d2net(net, torch.tensor(np.stack([gray] * 3, -1)),
                            num_keypoints=64)
    for a, b in zip(f[:3], ref[:3]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
