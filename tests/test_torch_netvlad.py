"""The port's NetVLAD against the JAX package's.

The JAX package's ``init_params`` (its 32,768 x 4,096 whitening is 512 MiB
in float32, so the file builds it once) go through
``netvlad_from_jax_params``; ``read_netvlad_mat`` and JAX's
``load_netvlad_mat`` read the same MatConvNet file.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs_localization_tpu.sfm import netvlad as jnv
from gs_localization_torch.sfm import netvlad as tnv

# tests/test_netvlad.py's bounds for its torch twin
RTOL, ATOL = 2e-3, 2e-5


@pytest.fixture(scope="module")
def params():
    return jax.tree_util.tree_map(np.asarray,
                                  jnv.init_params(np.random.default_rng(0)))


@pytest.fixture(scope="module")
def net(params):
    return tnv.netvlad_from_jax_params(params, "cpu")


def test_descriptor_matches_jax(params, net):
    rng = np.random.default_rng(1)
    img = rng.uniform(0, 1, (64, 80, 3)).astype(np.float32)
    ours = tnv.netvlad_descriptor(net, torch.tensor(img)).numpy()
    theirs = np.asarray(jnv.netvlad_descriptor(params, jnp.asarray(img)))
    assert ours.shape == (4096,)
    np.testing.assert_allclose(ours, theirs, rtol=RTOL, atol=ATOL)
    assert np.linalg.norm(ours) == pytest.approx(1.0, abs=1e-5)
    # batch_descriptors: host-side stack of the same descriptors
    imgs = [img, rng.uniform(0, 1, (64, 80, 3)).astype(np.float32)]
    np.testing.assert_allclose(tnv.batch_descriptors(net, imgs),
                               np.asarray(jnv.batch_descriptors(params,
                                                                imgs)),
                               rtol=RTOL, atol=ATOL)


def _small_params(rng):
    """hloc's layout at toy widths: 13 convs of a few channels, a 4-cluster
    NetVLAD layer, an 8-row whitening to 4,096."""
    feats, cin = [], 3
    for cout in (4, 4, 6, 6, 8, 8, 8, 8, 8, 8, 8, 8, 8):
        feats.append({
            "kernel": rng.standard_normal((3, 3, cin, cout)).astype(
                np.float32),
            "bias": rng.standard_normal(cout).astype(np.float32)})
        cin = cout
    return {"mean": rng.uniform(100, 140, 3).astype(np.float32),
            "features": feats,
            "score_w": rng.standard_normal((8, 4)).astype(np.float32),
            "centers": rng.standard_normal((8, 4)).astype(np.float32),
            "whiten": {"w": rng.standard_normal((8, 4096)).astype(
                           np.float32),
                       "b": rng.standard_normal(4096).astype(np.float32)}}


def test_netvlad_mat_reads_as_jax_does(tmp_path):
    """A MatConvNet ``*_struct.mat`` in hloc's layout (written by the
    port): both packages' readers give the same arrays, the written
    ones (centres negated on disk, whitening stored 1 x 1 x IN x OUT)."""
    p = _small_params(np.random.default_rng(2))
    path = str(tmp_path / "Pitts30K_struct.mat")
    tnv.write_netvlad_mat(p, path)
    ours = tnv.read_netvlad_mat(path)
    theirs = jnv.load_netvlad_mat(path)
    lj, tj = jax.tree_util.tree_flatten(theirs)
    lo, to = jax.tree_util.tree_flatten(ours)
    assert tj == to
    for a, b in zip(lo, lj):
        np.testing.assert_array_equal(a, np.asarray(b))
    for a, b in zip(lo, jax.tree_util.tree_leaves(p)):
        np.testing.assert_array_equal(a, b)
    net = tnv.load_netvlad_mat(path, "cpu")
    assert net["features"][0]["kernel"].shape == (4, 3, 3, 3)    # OIHW
    assert net["whiten"]["w"].shape == (8, 4096)
