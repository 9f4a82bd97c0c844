"""The port's SuperGlue against the JAX package's.

The same params (the JAX package's ``init_params``) go through
``superglue_from_jax_params``; an official-layout state dict
(``kenc.encoder.*``, ``gnn.layers.N.attn.{proj,merge}``,
``gnn.layers.N.mlp.*``, ``final_proj``, ``bin_score``) gives the same net.
Keypoints and descriptors are made from a seed.

Random weights at the JAX suite's own scale for random-parameter checks
(0.05, ``tests/test_superglue.py``): at 0.1 the 18 residual layers grow
the activations until the optimal transport saturates, and rounding
decides the matches in either package.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs_localization_tpu.sfm import superglue as jsg
from gs_localization_torch.sfm import superglue as tsg
from test_superglue import _identity_params, _random_inputs

TOL = 1e-5     # matching scores, log assignments


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(p):
    return jax.tree_util.tree_map(np.asarray, p)


def _both(p, inputs, size, iters, threshold=0.2):
    k0, s0, d0, k1, s1, d1 = inputs
    rj = jsg.superglue_match(p, k0, s0, d0, k1, s1, d1, *size, *size,
                             sinkhorn_iters=iters, match_threshold=threshold)
    net = tsg.superglue_from_jax_params(_np_tree(p), "cpu")
    rt = tsg.superglue_match(net, *[torch.tensor(np.asarray(a))
                                    for a in inputs], *size, *size,
                             sinkhorn_iters=iters, match_threshold=threshold)
    return rj, rt, net


@pytest.mark.parametrize("iters", [5, 50])
def test_superglue_match_matches_jax(iters):
    """64 / 48 keypoints, two of them invalid slots (-1, score 0) that stay
    in the attention: matches equal, scores within TOL."""
    rng = np.random.default_rng(0)
    p = jsg.init_params(rng, scale=0.05)
    k0, s0, d0, k1, s1, d1 = _random_inputs(rng, 64, 48)
    k0[-2:], s0[-2:], d0[-2:] = -1.0, 0.0, 0.0
    rj, rt, _ = _both(p, (k0, s0, d0, k1, s1, d1), (640, 480), iters,
                      threshold=0.0)
    assert int((rt.matches0 >= 0).sum()) > 0
    for f in ("matches0", "matches1"):
        np.testing.assert_array_equal(getattr(rt, f).numpy(),
                                      np.asarray(getattr(rj, f)))
    for f in ("matching_scores0", "matching_scores1"):
        np.testing.assert_allclose(getattr(rt, f).numpy(),
                                   np.asarray(getattr(rj, f)), atol=TOL)


def test_log_optimal_transport_marginals_and_jax():
    rng = np.random.default_rng(1)
    m, n = 13, 17
    scores = rng.standard_normal((m, n)).astype(np.float32)
    Zt = tsg.log_optimal_transport(torch.tensor(scores), torch.tensor(0.7),
                                   60).numpy()
    Zj = np.asarray(jsg.log_optimal_transport(jnp.asarray(scores),
                                              jnp.asarray(0.7), iters=60))
    np.testing.assert_allclose(Zt, Zj, atol=TOL)
    P = np.exp(Zt) / (m + n)
    np.testing.assert_allclose(P.sum(1)[:m], 1 / (m + n), atol=1e-4)
    np.testing.assert_allclose(P.sum(1)[m], n / (m + n), atol=1e-4)
    np.testing.assert_allclose(P.sum(0)[:n], 1 / (m + n), atol=1e-4)
    np.testing.assert_allclose(P.sum(0)[n], m / (m + n), atol=1e-4)


def test_identity_params_recover_permutation():
    """``tests/test_superglue.py``'s case: params that reduce the net to
    optimal transport of the raw descriptors find the permutation."""
    rng = np.random.default_rng(0)
    p = _identity_params(rng)
    n = 20
    kpts0, s0, d0, _, _, _ = _random_inputs(rng, n, n)
    perm = rng.permutation(n)
    d0 = d0 * 8.0
    d1 = d0[np.argsort(perm)]
    kpts1 = kpts0[np.argsort(perm)]
    rj, rt, _ = _both(p, (kpts0, s0, d0, kpts1, s0, d1), (640, 480), 50)
    np.testing.assert_array_equal(rt.matches0.numpy(), perm)
    np.testing.assert_array_equal(rt.matches1.numpy(), np.argsort(perm))
    np.testing.assert_array_equal(rt.matches0.numpy(),
                                  np.asarray(rj.matches0))
    assert np.all(rt.matching_scores0.numpy() > 0.2)
    pairs = tsg.matches_as_pairs(rt)
    np.testing.assert_array_equal(pairs, np.stack([np.arange(n), perm], 1))


def test_official_state_dict_matches_jax_params_route():
    """The net's own state dict (the official names and Conv1d shapes,
    ``num_batches_tracked`` left out as older files do) loads into the
    same net; the JAX converter reads that layout into params that give
    the same matches."""
    rng = np.random.default_rng(2)
    p = jsg.init_params(rng, scale=0.05)
    inputs = _random_inputs(rng, 40, 36)
    rj, rt, net = _both(p, inputs, (640, 480), 5, threshold=0.0)
    sd = {k: v.clone() for k, v in net.state_dict().items()
          if not k.endswith("num_batches_tracked")}
    assert "gnn.layers.17.attn.proj.2.weight" in sd
    assert sd["kenc.encoder.12.weight"].shape == (256, 256, 1)
    loaded = tsg.load_superglue(sd, "cpu")
    rl = tsg.superglue_match(loaded, *[torch.tensor(np.asarray(a))
                                       for a in inputs], 640, 480, 640, 480,
                             sinkhorn_iters=5, match_threshold=0.0)
    np.testing.assert_array_equal(rl.matches0.numpy(), rt.matches0.numpy())
    np.testing.assert_array_equal(rl.matching_scores0.numpy(),
                                  rt.matching_scores0.numpy())
    conv = jsg.convert_torch_weights_superglue(
        {k: v.numpy() for k, v in sd.items()})
    rc = jsg.superglue_match(conv, *inputs, 640, 480, 640, 480,
                             sinkhorn_iters=5, match_threshold=0.0)
    np.testing.assert_array_equal(rl.matches0.numpy(),
                                  np.asarray(rc.matches0))
    np.testing.assert_allclose(rl.matching_scores0.numpy(),
                               np.asarray(rc.matching_scores0), atol=TOL)
    del sd["final_proj.bias"]
    with pytest.raises(KeyError, match="final_proj.bias"):
        tsg.load_superglue(sd, "cpu")
