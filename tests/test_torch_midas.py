"""The port's MiDaS v2.1 against the JAX package's, at reduced
``stage_blocks`` (one bottleneck per stage) as ``tests/test_midas.py``
runs it. The weights are the JAX package's ``init_params`` (the port's
copy draws the same arrays); the official state dict that
``midas_state_dict`` writes reads back through JAX's converter at full
depth, and through the port's to the same net.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs_localization_tpu.ops import midas as jmd
from gs_localization_torch.ops import midas as tmd

TOL = 1e-4          # of the output's scale
SMALL = (1, 1, 1, 1)


@pytest.fixture(scope="module")
def params():
    return jax.tree_util.tree_map(
        np.asarray, jmd.init_params(np.random.default_rng(8),
                                    stage_blocks=SMALL))


@pytest.fixture(scope="module")
def net(params):
    return tmd.midas_from_jax_params(params, "cpu")


def _close_to_scale(ours, theirs):
    scale = max(1e-3, float(np.abs(theirs).max()))
    np.testing.assert_allclose(ours / scale, theirs / scale, atol=TOL)


def test_init_params_draws_as_jax(params):
    ours = tmd.init_params(np.random.default_rng(8), stage_blocks=SMALL)
    lo, to = jax.tree_util.tree_flatten(ours)
    lj, tj = jax.tree_util.tree_flatten(params)
    assert to == tj
    for a, b in zip(lo, lj):
        np.testing.assert_array_equal(a, b)


def test_midas_forward_matches_jax(params, net):
    img = np.random.default_rng(9).uniform(0, 1, (64, 96, 3)).astype(
        np.float32)
    theirs = np.asarray(jax.jit(jmd.midas_forward)(params, img))
    ours = tmd.midas_forward(net, torch.tensor(img)).numpy()
    assert ours.shape == (64, 96) and np.all(ours >= 0)
    _close_to_scale(ours, theirs)


def test_estimate_depth_matches_jax(params, net):
    img = np.random.default_rng(10).uniform(0, 1, (48, 60, 3)).astype(
        np.float32)
    theirs = np.asarray(jmd.estimate_depth(params, jnp.asarray(img), 48,
                                           60))
    ours = tmd.estimate_depth(net, torch.tensor(img), 48, 60).numpy()
    _close_to_scale(ours, theirs)
    est = tmd.make_midas_estimator(net)(img)
    np.testing.assert_array_equal(est, ours)


def test_state_dict_matches_jax_params_route(params, net):
    """At reduced depth: the port's converter on the written state dict
    gives the JAX-params route's net. At full depth (ResNeXt101 32x8d):
    JAX's converter reads the written layout back to the same params."""
    sd = tmd.midas_state_dict(params)
    loaded = tmd.load_midas({k: torch.tensor(v) for k, v in sd.items()},
                            "cpu")
    img = torch.tensor(np.random.default_rng(11).uniform(
        0, 1, (64, 64, 3)).astype(np.float32))
    np.testing.assert_array_equal(tmd.midas_forward(loaded, img).numpy(),
                                  tmd.midas_forward(net, img).numpy())
    full = tmd.init_params(np.random.default_rng(12))
    back = jmd.convert_torch_weights_midas(tmd.midas_state_dict(full))
    lb, tb = jax.tree_util.tree_flatten(back)
    lf, tf = jax.tree_util.tree_flatten(full)
    assert tb == tf and len(full["pretrained"]["layers"][2]) == 23
    for a, b in zip(lb, lf):
        np.testing.assert_array_equal(np.asarray(a), b)
