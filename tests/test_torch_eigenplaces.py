"""The port's EigenPlaces / CosPlace against the JAX package's.

The JAX package's ``init_params`` (resnet18, random batch-norm
statistics) go through ``eigenplaces_from_jax_params``; the hub model's
state dict (``backbone.{0,1,4..7}``, ``aggregation.{1,3}``) gives the same
net, and the JAX converter reads it into params that give the same
descriptor. Descriptors at 1e-5 (measured 1.6e-7 at unit norm).
"""

import jax
import numpy as np
import pytest
import torch

from gs_localization_tpu.sfm import eigenplaces as jep
from gs_localization_torch.sfm import eigenplaces as tep
from gs_localization_torch.sfm import registry as treg

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    return jep.init_params(np.random.default_rng(0), arch="resnet18",
                           fc_output_dim=128)


@pytest.fixture(scope="module")
def net(params):
    return tep.eigenplaces_from_jax_params(params, "cpu")


def _image(seed, h=64, w=96):
    return np.random.default_rng(seed).uniform(0, 1, (h, w, 3)).astype(
        np.float32)


def _jax_descriptor(params, img):
    return np.asarray(jax.jit(
        lambda im: jep.eigenplaces_descriptor(params, im))(img))


@pytest.mark.parametrize("seed,hw", [(1, (64, 96)), (2, (48, 64))])
def test_eigenplaces_descriptor_matches_jax(params, net, seed, hw):
    img = _image(seed, *hw)
    dt = tep.eigenplaces_descriptor(net, torch.tensor(img)).numpy()
    assert dt.shape == (128,)
    np.testing.assert_allclose(dt, _jax_descriptor(params, img), rtol=0,
                               atol=TOL)
    assert np.linalg.norm(dt) == pytest.approx(1.0, abs=1e-5)


def test_hub_state_dict_matches_jax_params_route(net):
    img = _image(3)
    ref = tep.eigenplaces_descriptor(net, torch.tensor(img))
    sd = {k: v.clone() for k, v in net.state_dict().items()}
    assert "backbone.7.1.bn2.running_var" in sd
    assert "aggregation.1.p" in sd and "aggregation.3.weight" in sd
    loaded = tep.load_eigenplaces(sd, arch="resnet18", device="cpu")
    torch.testing.assert_close(
        tep.eigenplaces_descriptor(loaded, torch.tensor(img)), ref, rtol=0,
        atol=0)
    conv = jep.convert_torch_weights_eigenplaces(
        {k: v.numpy() for k, v in sd.items()}, arch="resnet18")
    np.testing.assert_allclose(ref.numpy(), _jax_descriptor(conv, img),
                               rtol=0, atol=TOL)
    del sd["backbone.4.0.conv1.weight"]
    with pytest.raises(KeyError, match="backbone.4.0.conv1.weight"):
        tep.load_eigenplaces(sd, arch="resnet18", device="cpu")


@pytest.mark.parametrize("conf", ["eigenplaces", "cosplace"])
def test_registry_conf_is_eigenplaces_descriptor(net, conf):
    img = _image(4)
    d = treg.get_global_descriptor(conf, params=net)(img)
    torch.testing.assert_close(
        d, tep.eigenplaces_descriptor(net, torch.tensor(img)), rtol=0,
        atol=0)
