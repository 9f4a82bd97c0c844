"""The port's CUDA kernels on the card, held against the plain PyTorch
versions and the CPU path on the same seeded inputs.

Every test here needs an NVIDIA card and skips without one. The file
imports no JAX, so it also runs on a machine that has none:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

import gs_localization_torch as gsl
from gs_localization_torch.core import sh as sh_lib
from gs_localization_torch.core.camera import Camera
from gs_localization_torch.core.gaussians import FIELDS, GaussianParams
from gs_localization_torch.loc import TrackingConfig, refine_pose
from gs_localization_torch.raster import RasterizerConfig, rasterize
from gs_localization_torch.raster import stream_blend as sb
from gs_localization_torch.raster.pose_mode import (
    _project_stream, build_stream_pair_pack, render_pose_mode)

pytestmark = pytest.mark.cuda

CASES = {
    # tiles of several chunks each
    "multi_chunk": dict(seed=0, n=500, spread=1.0, chunk=32),
    # every tile single-chunk, some tiles empty (walk_count == 0)
    "single_chunk": dict(seed=4, n=40, spread=0.5, chunk=128),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _scene(seed: int, n: int, spread: float):
    """Random Gaussians in front of a camera at the origin, as numpy: the
    draws of ``tests/helpers.py::random_scene`` at SH degree 2."""
    rng = np.random.default_rng(seed)
    k = sh_lib.num_sh_coeffs(2)
    xyz = np.stack([rng.uniform(-spread, spread, n),
                    rng.uniform(-spread, spread, n),
                    rng.uniform(2.0, 6.0, n)], 1)
    fdc = sh_lib.rgb_to_sh_dc(rng.uniform(0.05, 0.95, (n, 3)))[:, None, :]
    frest = 0.1 * rng.standard_normal((n, k - 1, 3))
    scaling = rng.uniform(-3.5, -2.0, (n, 3))
    rot = rng.standard_normal((n, 4))
    rot /= np.linalg.norm(rot, axis=1, keepdims=True)
    return {"xyz": xyz, "features_dc": fdc, "features_rest": frest,
            "scaling": scaling, "rotation": rot,
            "opacity": rng.uniform(-1.0, 3.0, (n, 1)),
            "live": np.ones(n, bool)}


def _on(arrays, device):
    g = GaussianParams.from_numpy(arrays, 2, 2, device=device)
    fx = 96 / (2.0 * np.tan(0.5))
    cam = Camera.from_rt(np.eye(3), np.zeros(3), fx, fx, 96, 64,
                         device=device)
    return g, cam


@pytest.fixture(params=list(CASES))
def case(request, cuda_device):
    c = CASES[request.param]
    arrays = _scene(c["seed"], c["n"], c["spread"])
    cfg = RasterizerConfig(max_pairs=1 << 14, max_render=1 << 14, fast_k=1,
                           pallas_chunk=c["chunk"])
    g, cam = _on(arrays, cuda_device)
    pack = build_stream_pair_pack(g, cam, cfg)
    wc = pack.walk_counts.cpu().numpy()
    if request.param == "single_chunk":
        assert wc.max() <= c["chunk"] and (wc == 0).any()
    else:
        assert wc.max() > 2 * c["chunk"]
    with torch.no_grad():
        stream = _project_stream(pack.params, cam)
    return dict(arrays=arrays, cfg=cfg, pack=pack, stream=stream,
                chunk=c["chunk"], device=cuda_device)


def test_kernels_match_plain(case):
    pack, chunk = case["pack"], case["chunk"]
    args = (case["stream"], pack.tstart, pack.walk_counts, 6, 16, chunk)
    before = dict(gsl.LAUNCHES)
    acc_k, logt_k, resid_k = sb.stream_blend_fwd_cuda(*args)
    acc_p, logt_p, resid_p = sb.stream_blend_fwd_plain(*args)
    assert gsl.LAUNCHES["stream_fwd"] == before["stream_fwd"] + 1
    # sums in another order (sequential vs cumsum); log_t is held as
    # T = exp(log_t): a pair whose inclusive log T lies within rounding of
    # log(1e-4) is applied by one order and not the other
    torch.testing.assert_close(acc_k, acc_p, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(torch.exp(logt_k), torch.exp(logt_p),
                               atol=1e-5, rtol=1e-5)
    assert torch.equal(resid_k[..., 1], resid_p[..., 1])       # k_stop
    gen = torch.Generator().manual_seed(0)
    gacc = torch.randn(acc_k.shape, generator=gen).to(case["device"])
    glogt = (torch.randn(logt_k.shape, generator=gen).to(case["device"])
             * torch.exp(logt_k))
    d_k = sb.stream_blend_bwd_cuda(*args[:3], gacc, glogt, resid_k, 6, 16,
                                   chunk)
    d_p = sb.stream_blend_bwd_plain(*args[:3], gacc, glogt, 6, 16, chunk)
    torch.cuda.synchronize()
    assert gsl.LAUNCHES["stream_bwd"] == before["stream_bwd"] + 1
    # analytic reverse walk vs autograd of the forward, log T rebuilt by
    # subtraction: the JAX suite's Gaussian-gradient tolerance
    torch.testing.assert_close(d_k, d_p, atol=5e-3, rtol=1e-2)
    assert (d_k[[6, 7, 12, 13, 14, 15]] == 0).all()


def test_cuda_path_matches_cpu_path(case):
    cfg = case["cfg"]
    out = []
    for dev in (case["device"], torch.device("cpu")):
        g, cam = _on(case["arrays"], dev)
        pack = build_stream_pair_pack(g, cam, cfg)
        tau = torch.zeros(6, device=dev, requires_grad=True)
        c, d, a = render_pose_mode(pack, cam.with_delta(tau), cfg)
        (c.sum() + 0.1 * d.sum() + 0.01 * a.sum()).backward()
        out.append([x.detach().cpu() for x in (c, d, a, tau.grad)])
        with torch.no_grad():
            full = rasterize(g, cam, cfg)
        torch.testing.assert_close(full.color, c.detach(), atol=1e-5,
                                   rtol=0)
    for x_k, x_p in zip(out[0][:3], out[1][:3]):
        torch.testing.assert_close(x_k, x_p, atol=1e-5, rtol=0)
    torch.testing.assert_close(out[0][3], out[1][3], atol=1e-3, rtol=1e-3)


def test_refine_pose_cuda_matches_cpu(case):
    cfg = case["cfg"]
    tau = torch.tensor([0.01, -0.008, 0.012, 0.02, -0.015, 0.01])
    tcfg = TrackingConfig(num_iters=5, lr=1e-3, convergence=0.0,
                          rebin_every=10, pose_mode=True)
    res = []
    for dev in (case["device"], torch.device("cpu")):
        g, cam = _on(case["arrays"], dev)
        with torch.no_grad():
            gt = rasterize(g, cam, cfg)
        mask = torch.ones(gt.color.shape[:2], dtype=torch.bool, device=dev)
        res.append(refine_pose(g, cam.with_delta(tau.to(dev)), gt.color,
                               mask, tcfg, cfg, gt_depth=gt.depth))
    assert res[0].num_iters == res[1].num_iters == 5
    torch.testing.assert_close(res[0].w2c.cpu(), res[1].w2c, atol=1e-4,
                               rtol=0)


def test_wrappers_reject_bad_cuda_inputs(case):
    pack, chunk, stream = case["pack"], case["chunk"], case["stream"]
    with pytest.raises(TypeError, match="tstart"):
        sb.stream_blend_fwd_cuda(stream, pack.tstart.long(), pack.walk_counts,
                                 6, 16, chunk)
    with pytest.raises(ValueError, match="contiguous"):
        sb.stream_blend_fwd_cuda(stream.T.contiguous().T, pack.tstart,
                                 pack.walk_counts, 6, 16, chunk)
    with pytest.raises(ValueError, match="on cpu"):
        sb.stream_blend_fwd_cuda(stream, pack.tstart.cpu(), pack.walk_counts,
                                 6, 16, chunk)


def test_gaussian_fields_round_trip(cuda_device):
    arrays = _scene(1, 16, 1.0)
    g = GaussianParams.from_numpy(arrays, 2, 2, device=cuda_device)
    back = g.to_numpy()
    for f in FIELDS:
        np.testing.assert_allclose(back[f], np.asarray(arrays[f],
                                                       back[f].dtype))
