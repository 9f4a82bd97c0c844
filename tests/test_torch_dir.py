"""The port's DIR (ResNet-AP-GeM) against the JAX package's.

The JAX package's ResNet tree (``eigenplaces.init_params``, which draws
the same layout ``dir.py``'s converter reads, at resnet18 with random
batch-norm statistics) goes through ``dir_from_jax_params``; dirtorch's
state dict (with or without the ``module.`` prefix of the released file)
gives the same net, and the JAX converter reads it into params that give
the same descriptor. The whitening is a duck-typed object with sklearn's
PCA attributes, made from a seed. Descriptors at 1e-5 (measured 1.7e-7 at
unit norm).
"""

import jax
import numpy as np
import pytest
import torch

from gs_localization_tpu.sfm import dir as jdir
from gs_localization_tpu.sfm import eigenplaces as jep
from gs_localization_torch.sfm import dir as tdir
from gs_localization_torch.sfm import registry as treg

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _PCA:
    """sklearn's PCA attributes, as dirtorch checkpoints store them."""

    def __init__(self, rng, dim, n_comp, whiten=True):
        self.mean_ = 0.01 * rng.standard_normal(dim).astype(np.float32)
        self.components_ = rng.standard_normal((n_comp, dim)).astype(
            np.float32)
        self.explained_variance_ = rng.uniform(0.5, 2.0, n_comp).astype(
            np.float32)
        self.whiten = whiten


@pytest.fixture(scope="module")
def params():
    p = jep.init_params(np.random.default_rng(0), arch="resnet18",
                        fc_output_dim=128)
    p["gemp"] = 2.5
    return p


def _image(seed, h=64, w=96):
    return np.random.default_rng(seed).uniform(0, 1, (h, w, 3)).astype(
        np.float32)


def _jax_descriptor(params, img):
    return np.asarray(jax.jit(lambda im: jdir.dir_descriptor(params, im))(
        img))


@pytest.mark.parametrize("whiten", [None, True, False])
def test_dir_descriptor_matches_jax(params, whiten):
    """No whitening, PCA whitening, and PCA without the variance scaling
    (``whiten=False``); 64 of 128 components."""
    img = _image(1)
    p = dict(params)
    if whiten is not None:
        p["pca"] = jdir.load_pca_from_sklearn(
            _PCA(np.random.default_rng(2), 128, 64, whiten))
        assert tdir.load_pca_from_sklearn(
            _PCA(np.random.default_rng(2), 128, 64, whiten)).keys() == \
            p["pca"].keys()
    dj = _jax_descriptor(p, img)
    net = tdir.dir_from_jax_params(p, "cpu")
    dt = tdir.dir_descriptor(net, torch.tensor(img)).numpy()
    assert dt.shape == ((128,) if whiten is None else (64,))
    np.testing.assert_allclose(dt, dj, rtol=0, atol=TOL)
    assert np.linalg.norm(dt) == pytest.approx(1.0, abs=1e-5)


def test_whiten_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((5, 32)).astype(np.float32)
    pca = jdir.load_pca_from_sklearn(_PCA(rng, 32, 24))
    yj = np.asarray(jax.jit(lambda a: jdir.whiten(a, pca, whitenv=16))(x))
    tp = {k: v if k == "whiten" else torch.tensor(v) for k, v in pca.items()}
    yt = tdir.whiten(torch.tensor(x), tp, whitenv=16).numpy()
    np.testing.assert_allclose(yt, yj, rtol=0, atol=TOL)


def test_dirtorch_state_dict_matches_jax_params_route(params):
    """Bare and ``module.``-prefixed keys load into the same net, which
    keeps the learned GeM p; the JAX converter reads the bare keys to the
    same descriptor; a missing weight is named."""
    img = _image(4)
    net = tdir.dir_from_jax_params(params, "cpu")
    ref = tdir.dir_descriptor(net, torch.tensor(img))
    sd = {k: v.clone() for k, v in net.state_dict().items()}
    assert float(sd["adpool.p"]) == 2.5 and "layer4.0.downsample.1.bias" in sd
    for d in (sd, {f"module.{k}": v for k, v in sd.items()}):
        loaded = tdir.load_dir(d, arch="resnet18", device="cpu")
        torch.testing.assert_close(
            tdir.dir_descriptor(loaded, torch.tensor(img)), ref, rtol=0,
            atol=0)
    conv = jdir.convert_torch_weights_dir(
        {k: v.numpy() for k, v in sd.items()}, arch="resnet18")
    np.testing.assert_allclose(ref.numpy(), _jax_descriptor(conv, img),
                               rtol=0, atol=TOL)
    del sd["layer2.1.bn2.running_mean"]
    with pytest.raises(KeyError, match="layer2.1.bn2.running_mean"):
        tdir.load_dir(sd, arch="resnet18", device="cpu")


def test_registry_conf_is_dir_descriptor(params):
    net = tdir.dir_from_jax_params(params, "cpu")
    gray = _image(5)[..., 0]
    d = treg.get_global_descriptor("dir", params=net)(gray)
    ref = tdir.dir_descriptor(net, torch.tensor(np.stack([gray] * 3, -1)))
    torch.testing.assert_close(d, ref, rtol=0, atol=0)
