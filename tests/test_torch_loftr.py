"""The port's LoFTR against the JAX package's.

The JAX package's ``init_params`` go through ``loftr_from_jax_params``;
the state dict of an official ``.ckpt`` (keys under ``matcher.``) gives
the same net, and the JAX converter reads it into params that give the
same matches. Images are 64x96 (8x12 coarse cells) made from a seed; the
second is the first shifted by one coarse cell, so that cells match.

Tolerances, measured at these sizes: backbone maps 1e-5 of their scale
(measured 1.3e-6); the selected coarse cells and image1's keypoints
equal; image0's sub-pixel keypoints within 1e-5 of the image size
(measured 2.7e-4 px of 96); the dual-softmax confidences atol 1e-4
(measured 3.5e-5: the product of two softmaxes over similarities divided
by the 0.1 temperature; the JAX suite's twin bound is 2e-4,
``tests/test_loftr.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs_localization_tpu.sfm import loftr as jlf
from gs_localization_torch.sfm import loftr as tlf
from gs_localization_torch.sfm import registry as treg
from gs_localization_torch.sfm.features import rgb_to_gray

REL = 1e-5
SCORE_ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    return jax.tree_util.tree_map(
        np.asarray, jlf.init_params(np.random.default_rng(0)))


@pytest.fixture(scope="module")
def net(params):
    return tlf.loftr_from_jax_params(params, "cpu")


def _images(seed=1, h=64, w=96):
    img0 = np.random.default_rng(seed).uniform(0, 1, (h, w)).astype(
        np.float32)
    return img0, np.roll(img0, 8, axis=1)


def _same_matches(mt, mj, width):
    k1j = np.asarray(mj.kpts1)
    np.testing.assert_array_equal(mt.kpts1.numpy(), k1j)
    np.testing.assert_allclose(mt.kpts0.numpy(), np.asarray(mj.kpts0),
                               rtol=0, atol=REL * width)
    np.testing.assert_allclose(mt.scores.numpy(), np.asarray(mj.scores),
                               rtol=0, atol=SCORE_ATOL)
    live = np.asarray(mj.scores) > 0
    np.testing.assert_array_equal(mt.scores.numpy() > 0, live)
    return int(live.sum())


def test_backbone_matches_jax(params, net):
    img0, _ = _images()
    cj, fj = jax.jit(jlf.backbone_fpn)(params["backbone"], jnp.asarray(img0))
    ct, ft = tlf.backbone_fpn(net, torch.tensor(img0))
    assert ct.shape == (8, 12, 256) and ft.shape == (32, 48, 128)
    for a, b in ((ct, cj), (ft, fj)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=REL * np.abs(b).max())
    np.testing.assert_array_equal(tlf.sine_pos_encoding(8, 12),
                                  jlf.sine_pos_encoding(8, 12))


@pytest.mark.parametrize("threshold,max_matches", [(0.0, 32), (0.2, 96)])
def test_loftr_match_matches_jax(params, net, threshold, max_matches):
    """The selected cells (image1's keypoints, the order of the slots) are
    equal, dead slots included (score 0, keypoints -1); the sub-pixel
    keypoints and scores within the tolerances above."""
    img0, img1 = _images()
    mj = jlf.loftr_match(params, jnp.asarray(img0), jnp.asarray(img1),
                         max_matches=max_matches, match_threshold=threshold)
    mt = tlf.loftr_match(net, torch.tensor(img0), torch.tensor(img1),
                         max_matches=max_matches, match_threshold=threshold)
    assert mt.kpts0.shape == (max_matches, 2)
    n_live = _same_matches(mt, mj, img0.shape[1])
    assert n_live > 0
    if max_matches == 96:
        assert n_live < max_matches       # dead slots, all ties at 0
        assert np.all(mt.kpts0.numpy()[n_live:] == -1.0)


def test_official_checkpoint_matches_jax_params_route(net):
    """The ``.ckpt``'s ``state_dict`` (``matcher.`` prefix, the batch
    norms' counters) loads into the same net; the JAX converter reads it
    to the same matches; a missing weight is named."""
    img0, img1 = _images(2)
    sd = {f"matcher.{k}": v.clone() for k, v in net.state_dict().items()}
    assert "matcher.backbone.layer2.0.downsample.1.running_var" in sd
    assert "matcher.loftr_coarse.layers.7.mlp.2.weight" in sd
    loaded = tlf.load_loftr(sd, "cpu")
    args = (torch.tensor(img0), torch.tensor(img1))
    for a, b in zip(tlf.loftr_match(loaded, *args, max_matches=16),
                    tlf.loftr_match(net, *args, max_matches=16)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    conv = jlf.convert_torch_weights_loftr(
        {k: v.numpy() for k, v in sd.items()})
    mj = jlf.loftr_match(conv, jnp.asarray(img0), jnp.asarray(img1),
                         max_matches=16, match_threshold=0.0)
    mt = tlf.loftr_match(loaded, *args, max_matches=16, match_threshold=0.0)
    _same_matches(mt, mj, img0.shape[1])
    del sd["matcher.fine_preprocess.merge_feat.bias"]
    with pytest.raises(KeyError, match="merge_feat.bias"):
        tlf.load_loftr(sd, "cpu")


@pytest.mark.parametrize("conf,pitches", [("loftr", (1.0, 1.0)),
                                          ("loftr_aachen", (2.0, 8.0))])
def test_registry_dense_matcher_is_loftr_match(net, conf, pitches):
    """RGB numpy images go to the net's device as grayscale; the conf
    carries the aggregation pitches. 192x256: the registry's 512 slots
    need as many coarse cells."""
    img0, img1 = _images(3, 192, 256)
    rgb = [np.stack([im * 0.5, im, im * 0.25], -1) for im in (img0, img1)]
    matcher, cfg = treg.get_dense_matcher(conf, params=net)
    assert (cfg["max_error"], cfg["cell_size"]) == pitches
    k0, k1, sc = matcher(*rgb)
    ref = tlf.loftr_match(net, *[rgb_to_gray(torch.tensor(im))
                                 for im in rgb])
    for a, b in zip((k0, k1, sc), ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError, match="needs a loaded network"):
        treg.get_dense_matcher(conf)
