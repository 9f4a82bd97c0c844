"""The port's OpenIBL (``vgg16_netvlad``) against the JAX package's.

The JAX package's ``init_params`` go through ``openibl_from_jax_params``;
the hub model's state dict (``base_model.{i}``, ``net_vlad.*``) gives the
same net, and the JAX converter reads it into params that give the same
descriptor. Descriptors (32,768-d, unit norm) at 1e-5 of their largest
entry (measured 1.6e-7 of it).
"""

import jax
import numpy as np
import pytest
import torch

from gs_localization_tpu.sfm import openibl as joi
from gs_localization_torch.sfm import openibl as toi
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
        np.asarray, joi.init_params(np.random.default_rng(0)))


@pytest.fixture(scope="module")
def net(params):
    return toi.openibl_from_jax_params(params, "cpu")


def _image(seed, h=64, w=96):
    return np.random.default_rng(seed).uniform(0, 1, (h, w, 3)).astype(
        np.float32)


def _close(dt, dj):
    np.testing.assert_allclose(dt, dj, rtol=0, atol=REL * np.abs(dj).max())


@pytest.mark.parametrize("seed,hw", [(1, (64, 96)), (2, (48, 64))])
def test_openibl_descriptor_matches_jax(params, net, seed, hw):
    img = _image(seed, *hw)
    dj = np.asarray(joi.openibl_descriptor(params, img))
    dt = toi.openibl_descriptor(net, torch.tensor(img)).numpy()
    assert dt.shape == (toi.NUM_CLUSTERS * toi.FEATURE_DIM,)
    _close(dt, dj)
    assert np.linalg.norm(dt) == pytest.approx(1.0, abs=1e-5)


def test_hub_state_dict_matches_jax_params_route(net):
    img = _image(3)
    ref = toi.openibl_descriptor(net, torch.tensor(img))
    sd = {k: v.clone() for k, v in net.state_dict().items()}
    assert sd["net_vlad.conv.weight"].shape == (64, 512, 1, 1)
    assert "base_model.28.bias" in sd
    loaded = toi.load_openibl(sd, "cpu")
    torch.testing.assert_close(toi.openibl_descriptor(loaded,
                                                      torch.tensor(img)),
                               ref, rtol=0, atol=0)
    conv = joi.convert_torch_weights_openibl(
        {k: v.numpy() for k, v in sd.items()})
    _close(ref.numpy(), np.asarray(joi.openibl_descriptor(conv, img)))


def test_registry_conf_is_openibl_descriptor(net):
    img = _image(4)
    d = treg.get_global_descriptor("openibl", params=net)(img)
    torch.testing.assert_close(
        d, toi.openibl_descriptor(net, torch.tensor(img)), rtol=0, atol=0)
