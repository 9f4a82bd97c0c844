"""The port's DPT_Hybrid and its resizes against the JAX package's.

Full width (12 ViT-B blocks, 768 wide), as ``tests/test_dpt.py`` runs it,
on small images. The weights are the JAX package's ``init_params`` (the
port's copy draws the same arrays from the same seed); the hub-style state
dict that ``dpt_state_dict`` writes reads back through JAX's converter to
the same params, and through the port's to the same net. The resizes of
``estimate_depth`` (Keys cubic, antialiased when downscaling; bilinear
without antialiasing for the position embeddings; MiDaS's 2x bilinear)
are held against ``jax.image.resize`` both ways.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs_localization_tpu.ops import dpt as jdpt
from gs_localization_torch.ops import dpt as tdpt
from gs_localization_torch.ops.resize import resize

TOL_FWD = 5e-4      # of the output's scale (tests/test_dpt.py:168)
TOL_RESIZE = 1e-5


@pytest.fixture(scope="module")
def params():
    return jax.tree_util.tree_map(
        np.asarray, jdpt.init_params(np.random.default_rng(3)))


@pytest.fixture(scope="module")
def net(params):
    return tdpt.dpt_from_jax_params(params, "cpu")


def _close_to_scale(ours, theirs):
    scale = max(1.0, float(np.abs(theirs).max()))
    np.testing.assert_allclose(ours / scale, theirs / scale, atol=TOL_FWD)


@pytest.mark.parametrize("shape_in,shape_out,method,antialias", [
    ((480, 640, 3), (384, 512, 3), "cubic", True),
    ((384, 512), (480, 640), "cubic", True),
    ((64, 96, 3), (384, 512, 3), "cubic", True),
    ((384, 512), (48, 64), "cubic", True),
    ((24, 24, 768), (24, 32, 768), "bilinear", False),
    ((1, 32, 12, 16), (1, 32, 24, 32), "bilinear", True),
])
def test_resize_matches_jax(shape_in, shape_out, method, antialias):
    x = np.random.default_rng(4).uniform(0, 1, shape_in).astype(np.float32)
    theirs = np.asarray(jax.image.resize(jnp.asarray(x), shape_out, method,
                                         antialias=antialias))
    ours = resize(torch.tensor(x), shape_out, method, antialias).numpy()
    np.testing.assert_allclose(ours, theirs, atol=TOL_RESIZE)


def test_init_params_draws_as_jax(params):
    ours = tdpt.init_params(np.random.default_rng(3))
    lo, to = jax.tree_util.tree_flatten(ours)
    lj, tj = jax.tree_util.tree_flatten(params)
    assert to == tj
    for a, b in zip(lo, lj):
        np.testing.assert_array_equal(a, b)


def test_dpt_forward_matches_jax(params, net):
    img = np.random.default_rng(5).uniform(0, 1, (64, 96, 3)).astype(
        np.float32)
    theirs = np.asarray(jax.jit(jdpt.dpt_forward)(params, img))
    ours = tdpt.dpt_forward(net, torch.tensor(img)).numpy()
    assert ours.shape == (64, 96) and np.all(ours >= 0)
    _close_to_scale(ours, theirs)


def test_estimate_depth_matches_jax(params, net):
    """48x64 in, the net at 384x512, 48x64 out; and the estimator
    callback on a numpy image."""
    img = np.random.default_rng(6).uniform(0, 1, (48, 64, 3)).astype(
        np.float32)
    theirs = np.asarray(jdpt.estimate_depth(params, jnp.asarray(img), 48,
                                            64))
    ours = tdpt.estimate_depth(net, torch.tensor(img), 48, 64).numpy()
    _close_to_scale(ours, theirs)
    est = tdpt.make_dpt_estimator(net)(img)
    assert est.shape == (48, 64) and est.dtype == np.float32
    np.testing.assert_array_equal(est, ours)


def test_hub_state_dict_matches_jax_params_route(params, net):
    sd = tdpt.dpt_state_dict(params)
    assert sd["pretrained.model.patch_embed.backbone.stem.conv.weight"] \
        .shape == (64, 3, 7, 7)
    assert "pretrained.act_postprocess4.4.weight" in sd
    # JAX's converter reads the written layout back to the same params
    back = jdpt.convert_torch_weights_dpt(sd)
    lb, tb = jax.tree_util.tree_flatten(back)
    lp, tp = jax.tree_util.tree_flatten(params)
    assert tb == tp
    for a, b in zip(lb, lp):
        np.testing.assert_array_equal(np.asarray(a), b)
    # keys DPT does not read are ignored
    sd["pretrained.model.norm.weight"] = np.ones(768, np.float32)
    loaded = tdpt.load_dpt({k: torch.tensor(v) for k, v in sd.items()},
                           "cpu")
    img = torch.tensor(np.random.default_rng(7).uniform(
        0, 1, (64, 64, 3)).astype(np.float32))
    np.testing.assert_array_equal(tdpt.dpt_forward(loaded, img).numpy(),
                                  tdpt.dpt_forward(net, img).numpy())
