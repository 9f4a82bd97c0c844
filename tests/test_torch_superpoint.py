"""The port's SuperPoint against the JAX package's.

The same flax params (``SuperPointNet.init``) go through
``superpoint_from_jax_params``; an official-layout state dict (``conv1a``
... ``convDb``) loads with ``strict=True`` and gives the same net. Images
are made from a seed; the JAX side runs as its own tests run it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs_localization_tpu.sfm import superpoint as jsp
from gs_localization_torch.sfm import superpoint as tsp

TOL = 1e-5     # scores, descriptors (float32 convolutions in two libraries)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    p = jsp.SuperPointNet().init(jax.random.PRNGKey(0),
                                 jnp.zeros((64, 80)))["params"]
    return jax.tree_util.tree_map(np.asarray, p)


@pytest.fixture(scope="module")
def net(params):
    return tsp.superpoint_from_jax_params(params, "cpu")


def _image(h, w, seed):
    return np.random.default_rng(seed).uniform(0, 1, (h, w)).astype(
        np.float32)


@pytest.mark.parametrize("h,w", [(64, 80), (120, 160)])
def test_net_matches_jax(params, net, h, w):
    img = _image(h, w, 1)
    sj, dj = jsp.SuperPointNet().apply({"params": params}, jnp.asarray(img))
    with torch.no_grad():
        st, dt = net(torch.tensor(img))
    assert st.shape == (h, w) and dt.shape == (h // 8, w // 8, 256)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=TOL)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), atol=TOL)


def test_simple_nms_matches_jax():
    """Equal on a score map with plateaus and ties, at radius 2, 3, 4."""
    rng = np.random.default_rng(2)
    s = np.round(rng.uniform(0, 1, (40, 56)), 1).astype(np.float32)
    s[5, 5], s[5, 7] = 1.0, 0.8
    for r in (2, 3, 4):
        a = np.asarray(jsp.simple_nms(jnp.asarray(s), r))
        b = tsp.simple_nms(torch.tensor(s), r).numpy()
        np.testing.assert_array_equal(b, a)
    out = tsp.simple_nms(torch.tensor(s), 2).numpy()
    assert out[5, 5] == 1.0 and out[5, 7] == 0.0


@pytest.mark.parametrize("h,w,k,radius", [(64, 80, 64, 4),
                                          (120, 160, 256, 3)])
def test_extract_superpoint_matches_jax(params, net, h, w, k, radius):
    """Keypoints equal (no tied responses in these images), scores and
    descriptors within TOL."""
    img = _image(h, w, 3)
    fj = jsp.extract_superpoint(params, jnp.asarray(img), num_keypoints=k,
                                nms_radius=radius)
    ft = tsp.extract_superpoint(net, torch.tensor(img), num_keypoints=k,
                                nms_radius=radius)
    assert ft.keypoints.shape == (k, 2) and ft.descriptors.shape == (k, 256)
    assert int((ft.scores > 0).sum()) > k // 4
    np.testing.assert_array_equal(ft.keypoints.numpy(),
                                  np.asarray(fj.keypoints))
    np.testing.assert_allclose(ft.scores.numpy(), np.asarray(fj.scores),
                               atol=TOL)
    np.testing.assert_allclose(ft.descriptors.numpy(),
                               np.asarray(fj.descriptors), atol=TOL)


def test_official_state_dict_loads_strictly(params, net):
    """``superpoint_v1.pth``'s layout (torch OIHW convs under the official
    names) loads with strict=True and gives the JAX-params route's net."""
    sd = {}
    for name, p in params.items():
        sd[f"{name}.weight"] = torch.tensor(
            np.asarray(p["kernel"]).transpose(3, 2, 0, 1))
        sd[f"{name}.bias"] = torch.tensor(np.asarray(p["bias"]))
    loaded = tsp.load_superpoint(sd, "cpu")
    assert set(loaded.state_dict()) == set(sd)
    img = torch.tensor(_image(64, 80, 4))
    with torch.no_grad():
        for a, b in zip(loaded(img), net(img)):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
    with pytest.raises(RuntimeError, match="Missing key"):
        tsp.load_superpoint({k: v for k, v in sd.items()
                             if k != "convDb.bias"}, "cpu")
    # the JAX converter reads the same file layout into the same net
    conv = jsp.convert_torch_weights({k: v.numpy() for k, v in sd.items()})
    sj, _ = jsp.SuperPointNet().apply({"params": conv}, jnp.asarray(img))
    np.testing.assert_allclose(loaded(img)[0].numpy(), np.asarray(sj),
                               atol=TOL)
