"""The port's DISK against the JAX package's.

The JAX package's ``init_params`` go through ``disk_from_jax_params``; a
state dict in the converter's layout (``unet.path_{down,up}.{i}.unit.*``)
gives the same net, and the JAX converter reads it into params that give
the same features. Images are RGB from a seed, H and W divisible by 16.

Tolerances, measured at these sizes: the U-Net output at 1e-5 of its
scale (measured 1.7e-6); the keypoints (pixels, so the slots' order)
equal, dead slots at 0.0 as in JAX; scores at 1e-5 of their scale;
descriptors atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs_localization_tpu.sfm import disk as jdk
from gs_localization_torch.sfm import disk as tdk
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
        np.asarray, jdk.init_params(np.random.default_rng(0)))


@pytest.fixture(scope="module")
def net(params):
    return tdk.disk_from_jax_params(params, "cpu")


def _image(seed, h=64, w=96):
    return np.random.default_rng(seed).uniform(0, 1, (h, w, 3)).astype(
        np.float32)


def _same_features(ft, fj):
    sj = np.asarray(fj.scores)
    np.testing.assert_array_equal(ft.keypoints.numpy(),
                                  np.asarray(fj.keypoints))
    np.testing.assert_allclose(ft.scores.numpy(), sj, rtol=0,
                               atol=REL * np.abs(sj).max())
    np.testing.assert_allclose(ft.descriptors.numpy(),
                               np.asarray(fj.descriptors), rtol=0, atol=REL)
    return int((sj > 0).sum())


def test_unet_forward_matches_jax(params, net):
    img = _image(1)
    oj = np.asarray(jax.jit(jdk.unet_forward)(params, jnp.asarray(img)))
    ot = tdk.unet_forward(net, torch.tensor(img)).numpy()
    assert ot.shape == (64, 96, 129)
    np.testing.assert_allclose(ot, oj, rtol=0, atol=REL * np.abs(oj).max())


@pytest.mark.parametrize("seed,hw,k,window", [(2, (64, 96), 256, 5),
                                              (3, (48, 64), 512, 3)])
def test_extract_disk_matches_jax(params, net, seed, hw, k, window):
    """At 512 slots of 3,072 pixels with NMS 3 some slots are dead: their
    keypoints are 0.0, not -1, as in JAX."""
    img = _image(seed, *hw)
    fj = jdk.extract_disk(params, jnp.asarray(img), num_keypoints=k,
                          window_size=window)
    ft = tdk.extract_disk(net, torch.tensor(img), num_keypoints=k,
                          window_size=window)
    n_live = _same_features(ft, fj)
    assert 0 < n_live
    if n_live < k:
        assert np.all(ft.keypoints.numpy()[n_live:] == 0.0)


def test_official_layout_matches_jax_params_route(net):
    img = _image(4)
    sd = {k: v.clone() for k, v in net.state_dict().items()}
    assert "unet.path_up.3.unit.gate.weight" in sd
    assert "unet.path_down.0.unit.gate.weight" not in sd
    ref = tdk.extract_disk(net, torch.tensor(img), num_keypoints=128)
    f = tdk.extract_disk(tdk.load_disk(sd, "cpu"), torch.tensor(img),
                         num_keypoints=128)
    for a, b in zip(f[:3], ref[:3]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    conv = jdk.convert_torch_weights_disk(
        {k: v.numpy() for k, v in sd.items()})
    _same_features(ref, jdk.extract_disk(conv, jnp.asarray(img),
                                         num_keypoints=128))


def test_registry_conf_is_extract_disk(net):
    """disk: window 5 from the conf; a grayscale image is stacked to RGB."""
    gray = _image(5)[..., 1]
    f = treg.get_extractor("disk", params=net, num_keypoints=64)(gray)
    ref = tdk.extract_disk(net, torch.tensor(np.stack([gray] * 3, -1)),
                           num_keypoints=64, window_size=5)
    for a, b in zip(f[:3], ref[:3]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
