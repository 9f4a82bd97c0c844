"""The port's LightGlue against the JAX package's.

The JAX package's ``init_params`` (scale 0.05) go through
``lightglue_from_jax_params``; the official state dict, under both of its
namings, gives the same net, and the JAX converter reads it into params
that give the same matches. Keypoints and descriptors come from a seed;
two invalid slots (-1, zero descriptor) stay in the attention, as in JAX.

The log assignment is held at 1e-5 of its scale (measured 2.5e-6 after 9
layers at these sizes). The matching scores are exp of log-assignment
entries near 0, each the sum of two log-softmaxes and a certainty term of
magnitude up to ~120, so their absolute error is the log assignment's:
atol 1e-4 (measured 2.8e-5; the JAX suite's twin bound is 2e-4,
``tests/test_lightglue.py``).
"""

import jax
import numpy as np
import pytest
import torch

from gs_localization_tpu.sfm import lightglue as jlg
from gs_localization_torch.sfm import lightglue as tlg
from gs_localization_torch.sfm import registry as treg
from gs_localization_torch.sfm.features import Features

REL = 1e-5       # log assignment, of its scale
SCORE_ATOL = 1e-4
SIZE = (640, 480)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    return jax.tree_util.tree_map(
        np.asarray, jlg.init_params(np.random.default_rng(0)))


def _inputs(seed, n0=128, n1=96):
    rng = np.random.default_rng(seed)
    k0 = rng.uniform(0, 640, (n0, 2)).astype(np.float32)
    k1 = rng.uniform(0, 480, (n1, 2)).astype(np.float32)
    d0 = rng.standard_normal((n0, tlg.DIM)).astype(np.float32)
    d1 = rng.standard_normal((n1, tlg.DIM)).astype(np.float32)
    d0 /= np.linalg.norm(d0, axis=1, keepdims=True)
    d1 /= np.linalg.norm(d1, axis=1, keepdims=True)
    k0[-2:], d0[-2:] = -1.0, 0.0
    return k0, d0, k1, d1


@jax.jit
def _jax_assignment(p, k0, d0, k1, d1):
    enc0 = jlg.fourier_rotary_encoding(
        p["posenc"], jlg.normalize_keypoints(k0, *SIZE))
    enc1 = jlg.fourier_rotary_encoding(
        p["posenc"], jlg.normalize_keypoints(k1, *SIZE))
    x0 = jlg._linear(p["input_proj"], d0)
    x1 = jlg._linear(p["input_proj"], d1)
    for lyr in p["layers"]:
        x0 = jlg._self_block(lyr["self_attn"], x0, enc0)
        x1 = jlg._self_block(lyr["self_attn"], x1, enc1)
        x0, x1 = jlg._cross_block(lyr["cross_attn"], x0, x1)
    return jlg.match_assignment(p["log_assignment"], x0, x1)


def _torch_assignment(net, k0, d0, k1, d1):
    k0, d0, k1, d1 = map(torch.tensor, (k0, d0, k1, d1))
    with torch.no_grad():
        enc0 = tlg.fourier_rotary_encoding(
            net.posenc, tlg.normalize_keypoints(k0, *SIZE))
        enc1 = tlg.fourier_rotary_encoding(
            net.posenc, tlg.normalize_keypoints(k1, *SIZE))
        x0 = tlg._linear(net.input_proj, d0)
        x1 = tlg._linear(net.input_proj, d1)
        for lyr in net.transformers:
            x0 = tlg._self_block(lyr.self_attn, x0, enc0)
            x1 = tlg._self_block(lyr.self_attn, x1, enc1)
            x0, x1 = tlg._cross_block(lyr.cross_attn, x0, x1)
        return tlg.match_assignment(net.log_assignment[-1], x0, x1).numpy()


def _match(net, inputs, threshold=0.0):
    return tlg.lightglue_match(net, *map(torch.tensor, inputs), *SIZE, *SIZE,
                               match_threshold=threshold)


def _same_result(rt, rj):
    for f in ("matches0", "matches1"):
        np.testing.assert_array_equal(getattr(rt, f).numpy(),
                                      np.asarray(getattr(rj, f)))
    for f in ("matching_scores0", "matching_scores1"):
        np.testing.assert_allclose(getattr(rt, f).numpy(),
                                   np.asarray(getattr(rj, f)),
                                   atol=SCORE_ATOL, rtol=0)


@pytest.mark.parametrize("threshold", [0.0, 0.1])
def test_lightglue_match_matches_jax(params, threshold):
    """Log assignment within 1e-5 of its scale; mutual matches equal;
    matching scores within SCORE_ATOL; int64 indices."""
    inputs = _inputs(1)
    net = tlg.lightglue_from_jax_params(params, "cpu")
    zj = np.asarray(_jax_assignment(params, *inputs))
    zt = _torch_assignment(net, *inputs)
    assert zt.shape == (129, 97)
    np.testing.assert_allclose(zt, zj, rtol=0,
                               atol=REL * np.abs(zj).max())
    rj = jlg.lightglue_match(params, *inputs, *SIZE, *SIZE,
                             match_threshold=threshold)
    rt = _match(net, inputs, threshold)
    assert rt.matches0.dtype == torch.int64
    assert int((rt.matches0 >= 0).sum()) > 0
    _same_result(rt, rj)


def test_sigmoid_log_double_softmax_matches_jax():
    rng = np.random.default_rng(2)
    sim = rng.standard_normal((8, 11)).astype(np.float32) * 10
    z0 = rng.standard_normal(8).astype(np.float32)
    z1 = rng.standard_normal(11).astype(np.float32)
    zj = np.asarray(jax.jit(jlg.sigmoid_log_double_softmax)(sim, z0, z1))
    zt = tlg.sigmoid_log_double_softmax(*map(torch.tensor, (sim, z0, z1)))
    np.testing.assert_allclose(zt.numpy(), zj, rtol=0,
                               atol=REL * np.abs(zj).max())


def test_official_state_dict_both_namings(params):
    """The published naming (``self_attn.{i}.*``) and the in-code one
    (``transformers.{i}.self_attn.*``) load into the same net; the
    ``token_confidence`` heads are not read; a missing weight is named;
    the JAX converter reads the published file to the same matches."""
    inputs = _inputs(3, 64, 72)
    net = tlg.lightglue_from_jax_params(params, "cpu")
    rt = _match(net, inputs)
    published = tlg.lightglue_state_dict(net)
    assert "self_attn.8.Wqkv.weight" in published
    assert "cross_attn.0.ffn.3.bias" in published
    assert not any(k.startswith("transformers.") for k in published)
    in_code = {k: v.clone() for k, v in net.state_dict().items()}
    in_code["token_confidence.0.token.0.weight"] = torch.zeros(1, tlg.DIM)
    for sd in (published, in_code):
        r = _match(tlg.load_lightglue(sd, "cpu"), inputs)
        for a, b in zip(r, rt):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    conv = jlg.convert_torch_weights_lightglue(
        {k: v.numpy() for k, v in published.items()})
    _same_result(rt, jlg.lightglue_match(conv, *inputs, *SIZE, *SIZE,
                                         match_threshold=0.0))
    del published["input_proj.bias"]
    with pytest.raises(KeyError, match="input_proj.bias"):
        tlg.load_lightglue(published, "cpu")


@pytest.mark.parametrize("conf", ["lightglue", "superpoint+lightglue"])
def test_registry_conf_is_lightglue_match(params, conf):
    k0, d0, k1, d1 = _inputs(4, 48, 40)
    net = tlg.lightglue_from_jax_params(params, "cpu")

    def feats(k, d):
        return Features(torch.tensor(k), torch.ones(len(k)), torch.tensor(d))

    r = treg.get_matcher(conf, params=net)(feats(k0, d0), feats(k1, d1),
                                           (640, 480), (640, 480))
    ref = tlg.lightglue_match(net, *map(torch.tensor, (k0, d0, k1, d1)),
                              640, 480, 640, 480)
    for a, b in zip(r, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
