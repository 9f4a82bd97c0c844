"""The port's R2D2 against the JAX package's.

The JAX package's ``init_params`` go through ``r2d2_from_jax_params``;
the state dict of ``r2d2_WASF_N16.pt`` (with or without the ``module.``
prefix of the released file) gives the same net, and the JAX converter
reads it into params that give the same features. Images are RGB from a
seed.

Tolerances, measured at these sizes: the descriptors at 1e-5 (measured
4.5e-7); the reliability and repeatability, a 2-class softmax and a
softplus ratio of head logits that agree to 3e-6 of their scale, at the
JAX suite's twin bound (rtol 2e-3, atol 2e-5, ``tests/test_r2d2.py``;
measured 2.1e-5 at values near 1); the keypoints (pixels, so the slots'
order) equal, scores atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs_localization_tpu.sfm import r2d2 as jr2
from gs_localization_torch.sfm import r2d2 as tr2
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
        np.asarray, jr2.init_params(np.random.default_rng(0)))


@pytest.fixture(scope="module")
def net(params):
    return tr2.r2d2_from_jax_params(params, "cpu")


def _image(seed, h=64, w=96):
    return np.random.default_rng(seed).uniform(0, 1, (h, w, 3)).astype(
        np.float32)


def _same_features(ft, fj):
    np.testing.assert_array_equal(ft.keypoints.numpy(),
                                  np.asarray(fj.keypoints))
    np.testing.assert_allclose(ft.scores.numpy(), np.asarray(fj.scores),
                               rtol=0, atol=REL)
    np.testing.assert_allclose(ft.descriptors.numpy(),
                               np.asarray(fj.descriptors), rtol=0, atol=REL)
    return int((ft.scores > 0).sum())


def test_forward_matches_jax(params, net):
    img = _image(1)
    dj, lj, pj = (np.asarray(a) for a in
                  jax.jit(jr2.r2d2_forward)(params, jnp.asarray(img)))
    dt, lt, pt = (a.numpy() for a in tr2.r2d2_forward(net, torch.tensor(img)))
    assert dt.shape == (64, 96, 128) and lt.shape == pt.shape == (64, 96)
    np.testing.assert_allclose(dt, dj, rtol=0, atol=REL)
    np.testing.assert_allclose(lt, lj, rtol=2e-3, atol=2e-5)
    np.testing.assert_allclose(pt, pj, rtol=2e-3, atol=2e-5)


@pytest.mark.parametrize("seed,hw,k", [(2, (64, 96), 256), (3, (48, 64), 64)])
def test_extract_r2d2_matches_jax(params, net, seed, hw, k):
    img = _image(seed, *hw)
    fj = jr2.extract_r2d2(params, jnp.asarray(img), num_keypoints=k)
    ft = tr2.extract_r2d2(net, torch.tensor(img), num_keypoints=k)
    assert ft.keypoints.shape == (k, 2)
    assert _same_features(ft, fj) > 0


def test_official_state_dict_matches_jax_params_route(net):
    """``module.``-prefixed and bare keys load into the same net (the
    batch norms' counters may be absent); the JAX converter reads the bare
    keys to the same features; a missing statistic is named."""
    img = _image(4)
    sd = {k: v.clone() for k, v in net.state_dict().items()}
    assert "ops.19.running_var" in sd and "ops.22.weight" in sd
    ref = tr2.extract_r2d2(net, torch.tensor(img), num_keypoints=128)
    for d in (sd, {f"module.{k}": v for k, v in sd.items()
                   if not k.endswith("num_batches_tracked")}):
        f = tr2.extract_r2d2(tr2.load_r2d2(d, "cpu"), torch.tensor(img),
                             num_keypoints=128)
        for a, b in zip(f[:3], ref[:3]):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    conv = jr2.convert_torch_weights_r2d2(
        {k: v.numpy() for k, v in sd.items()})
    _same_features(ref, jr2.extract_r2d2(conv, jnp.asarray(img),
                                         num_keypoints=128))
    del sd["ops.1.running_mean"]
    with pytest.raises(KeyError, match="ops.1.running_mean"):
        tr2.load_r2d2(sd, "cpu")


def test_registry_conf_is_extract_r2d2(net):
    img = _image(5)
    f = treg.get_extractor("r2d2", params=net, num_keypoints=64)(img)
    ref = tr2.extract_r2d2(net, torch.tensor(img), num_keypoints=64)
    for a, b in zip(f[:3], ref[:3]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
