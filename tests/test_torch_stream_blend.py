"""Stream blend: the port's plain versions of K1/K2 against the JAX Pallas
kernels in interpret mode, on streams built by the JAX package. The CUDA
kernels are held against the plain versions in test_torch_cuda.py."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import gs_localization_torch as gsl
from gs_localization_tpu.raster import RasterizerConfig as JConfig
from gs_localization_tpu.raster import stream_blend as jsb
from gs_localization_tpu.raster.pose_mode import (
    _project_stream as j_project_stream,
    build_stream_pair_pack as j_build_pack)
from gs_localization_torch.raster import stream_blend as sb
from helpers import make_camera, random_scene
from torch_bridge import np_of

CASES = {
    # tiles of several chunks each (chunk 32)
    "multi_chunk": dict(seed=0, n=500, spread=1.0, chunk=32),
    # every tile single-chunk, border tiles empty (walk_count == 0): the
    # regime of the TPU runtime fault, KNOWN_ISSUES.md #1
    "single_chunk": dict(seed=4, n=40, spread=0.5, chunk=128),
}


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    c = CASES[request.param]
    g = random_scene(np.random.default_rng(c["seed"]), c["n"],
                     spread=c["spread"])
    cam = make_camera(96, 64, fov=1.0)
    cfg = JConfig(max_pairs=1 << 14, max_render=1 << 14, fast_k=1,
                  backend="pallas_interpret", pallas_chunk=c["chunk"])
    pack = j_build_pack(g, cam, cfg)
    stream = j_project_stream(pack.params, cam)
    wc = np.asarray(pack.walk_counts)
    if request.param == "single_chunk":
        assert wc.max() <= c["chunk"] and (wc == 0).any()
    else:
        assert wc.max() > 2 * c["chunk"]
    return dict(stream=stream, tstart=pack.tstart, wcount=pack.walk_counts,
                kept_al=pack.kept_al, grid_x=6, chunk=c["chunk"])


def _torch_inputs(c):
    return (torch.tensor(np.asarray(c["stream"])),
            torch.tensor(np.asarray(c["tstart"])),
            torch.tensor(np.asarray(c["wcount"])))


def test_plain_forward_matches_pallas(case):
    c = case
    num_tiles = c["tstart"].shape[0]
    fwd_call, _ = jsb._make_stream_calls(num_tiles, c["grid_x"], 16,
                                         c["chunk"], c["stream"].shape[1],
                                         True)
    acc_j, logt_j, resid_j = fwd_call(c["tstart"], c["wcount"], c["stream"])
    stream, tstart, wcount = _torch_inputs(c)
    acc, logt, resid = sb.stream_blend_fwd_plain(stream, tstart, wcount,
                                                 c["grid_x"], 16, c["chunk"])
    np.testing.assert_allclose(np_of(acc), np_of(acc_j), atol=3e-5,
                               rtol=3e-5)
    np.testing.assert_allclose(np_of(logt), np_of(logt_j), atol=3e-5,
                               rtol=3e-5)
    np.testing.assert_allclose(np_of(resid)[..., 0], np_of(resid_j)[..., 0],
                               atol=3e-5, rtol=3e-5)
    np.testing.assert_array_equal(np_of(resid)[..., 1],
                                  np_of(resid_j)[..., 1])      # k_stop


def test_direct_blend_grad_matches_pallas(case):
    c = case
    num_tiles = c["tstart"].shape[0]
    rng = np.random.default_rng(1)
    wc = rng.standard_normal((num_tiles, 256, 3)).astype(np.float32)
    wd = rng.standard_normal((num_tiles, 256)).astype(np.float32)
    wt = rng.standard_normal((num_tiles, 256)).astype(np.float32)

    def jloss(s):
        out = jsb.blend_stream_direct(s, c["tstart"], c["wcount"],
                                      c["kept_al"], c["grid_x"], 16,
                                      chunk=c["chunk"], interpret=True)
        return (jnp.sum(out.color * wc) + jnp.sum(out.depth * wd)
                + jnp.sum(jnp.exp(out.log_t) * wt))

    g_j = np.asarray(jax.grad(jloss)(c["stream"]))
    stream, tstart, wcount = _torch_inputs(c)
    stream.requires_grad_()
    before = dict(gsl.LAUNCHES)
    out = sb.blend_stream_direct(stream, tstart, wcount,
                                 torch.tensor(np.asarray(c["kept_al"])),
                                 c["grid_x"], 16, chunk=c["chunk"])
    loss = ((out.color * torch.tensor(wc)).sum()
            + (out.depth * torch.tensor(wd)).sum()
            + (torch.exp(out.log_t) * torch.tensor(wt)).sum())
    loss.backward()
    assert gsl.LAUNCHES == before      # CPU tensors take the plain versions
    np.testing.assert_allclose(float(loss.detach()),
                               float(jloss(c["stream"])),
                               rtol=1e-5)
    g = np_of(stream.grad)
    kept_al = int(c["kept_al"])
    assert (g[:, kept_al:] == 0).all()
    assert (g[[6, 7, 12, 13, 14, 15]] == 0).all()
    np.testing.assert_allclose(g, g_j, atol=5e-3, rtol=1e-2)
    assert np.abs(g).max() > 0


def test_cuda_wrapper_rejects_bad_inputs(case):
    stream, tstart, wcount = _torch_inputs(case)
    with pytest.raises(ValueError, match="CUDA tensors"):
        sb.stream_blend_fwd_cuda(stream, tstart, wcount, 6, 16, 32)
    with pytest.raises(ValueError, match="tile_size"):
        sb.stream_blend_fwd_cuda(stream, tstart, wcount, 6, 8, 32)
    with pytest.raises(ValueError, match="chunk"):
        sb.stream_blend_bwd_cuda(stream, tstart, wcount, None, None, None,
                                 6, 16, 48)
