"""Pregathered blend: the port's plain versions of K3/K4 against the JAX
Pallas kernels in interpret mode, on the same seeded windows. The CUDA
kernels are held against the plain versions in test_torch_cuda.py."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import gs_localization_torch as gsl
from gs_localization_tpu.raster import pallas_blend as jpb
from gs_localization_torch.raster import pallas_blend as pb
from torch_bridge import np_of

GRID_X, GRID_Y, CAP, CHUNK = 3, 2, 128, 32
# tile 0 empty; tile 1 saturates in its first chunk of four (early exit);
# tile 2 walks all four chunks without saturating; tile 3 ends mid-chunk;
# tiles 4, 5 mixed. Lanes past the count hold live-looking garbage.
COUNTS = np.array([0, 128, 128, 37, 90, 64], np.int32)


def _windows(seed: int = 0):
    rng = np.random.default_rng(seed)
    t = np.arange(GRID_X * GRID_Y)
    ox = ((t % GRID_X) * 16 + 7.5)[:, None]
    oy = ((t // GRID_X) * 16 + 7.5)[:, None]
    shape = (len(t), CAP)
    x = ox + rng.uniform(-14, 14, shape)
    y = oy + rng.uniform(-14, 14, shape)
    sa = rng.uniform(0.02, 0.4, shape)
    sc = rng.uniform(0.02, 0.4, shape)
    b = rng.uniform(-0.5, 0.5, shape) * np.sqrt(sa * sc)
    opa = rng.uniform(0.05, 0.6, shape)
    # tile 1: wide, opaque splats at the tile centre saturate every pixel
    x[1], y[1] = ox[1] + rng.uniform(-2, 2, CAP), oy[1] + rng.uniform(-2, 2, CAP)
    sa[1], sc[1], b[1], opa[1] = 0.005, 0.005, 0.0, 0.95
    # tile 2: faint splats never saturate
    opa[2] = rng.uniform(0.01, 0.05, CAP)
    valid = (rng.uniform(size=shape) > 0.1).astype(np.float64)
    geom = np.stack([x, y, sa, b, sc, opa, valid, np.zeros(shape)], 1)
    rgbd = np.concatenate([rng.uniform(0, 1, (len(t), 3, CAP)),
                           rng.uniform(1, 5, (len(t), 1, CAP))], 1)
    return geom.astype(np.float32), rgbd.astype(np.float32)


@pytest.fixture(scope="module")
def windows():
    return _windows()


def _t(a):
    return torch.tensor(np.asarray(a))


def _weights():
    """Seeded weights of the test loss on color, depth and T."""
    rng = np.random.default_rng(1)
    npix = 256
    wc = rng.standard_normal((6, npix, 3)).astype(np.float32)
    wd = rng.standard_normal((6, npix)).astype(np.float32)
    wt = rng.standard_normal((6, npix)).astype(np.float32)
    return wc, wd, wt


@pytest.fixture(scope="module")
def jax_ref(windows):
    """The Pallas kernels in interpret mode: K3's outputs, and the loss's
    value and gradients through K4."""
    geom, rgbd = windows
    fwd_call, _ = jpb._make_core_calls(GRID_X * GRID_Y, GRID_X, 16, CAP,
                                       CHUNK, True)
    fwd = [np.asarray(x) for x in fwd_call(
        jnp.asarray(COUNTS), jnp.asarray(geom), jnp.asarray(rgbd))]
    wc, wd, wt = _weights()

    def jloss(g, r):
        out = jpb.blend_pregathered_pallas(jnp.asarray(COUNTS), g, r, GRID_X,
                                           16, chunk=CHUNK, interpret=True)
        return (jnp.sum(out.color * wc) + jnp.sum(out.depth * wd)
                + jnp.sum(jnp.exp(out.log_t) * wt))

    loss, (gj, rj) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(geom), jnp.asarray(rgbd))
    return dict(fwd=fwd, loss=float(loss), dgeom=np.asarray(gj),
                drgbd=np.asarray(rj))


def test_plain_forward_matches_pallas(windows, jax_ref):
    geom, rgbd = windows
    acc_j, logt_j, resid_j = jax_ref["fwd"]
    acc, logt, resid = pb.pregathered_blend_fwd_plain(
        _t(COUNTS), _t(geom), _t(rgbd), GRID_X, 16, CHUNK)
    # sums in another order (cumsum vs the TPU's triangular matmul)
    np.testing.assert_allclose(np_of(acc), np_of(acc_j), atol=3e-5,
                               rtol=3e-5)
    np.testing.assert_allclose(np_of(logt), np_of(logt_j), atol=3e-5,
                               rtol=3e-5)
    np.testing.assert_allclose(np_of(resid)[..., 0], np_of(resid_j)[..., 0],
                               atol=3e-5, rtol=3e-5)
    k_stop = np_of(resid)[:, 0, 1]
    np.testing.assert_array_equal(np_of(resid)[..., 1],
                                  np_of(resid_j)[..., 1])
    # empty tile: nothing walked; saturated tile: early exit after chunk 1;
    # faint tile: all four chunks
    assert k_stop[0] == 0 and k_stop[1] == 1 and k_stop[2] == 4
    assert (np_of(acc)[0] == 0).all() and (np_of(logt)[0] == 0).all()
    assert np_of(resid)[1, :, 0].max() < np.log(1e-4)   # every pixel


def test_vjp_matches_pallas(windows, jax_ref):
    geom, rgbd = windows
    wc, wd, wt = _weights()
    gj, rj = jax_ref["dgeom"], jax_ref["drgbd"]
    g, r = _t(geom).requires_grad_(), _t(rgbd).requires_grad_()
    before = dict(gsl.LAUNCHES)
    out = pb.blend_pregathered_pallas(_t(COUNTS), g, r, GRID_X, 16,
                                      chunk=CHUNK)
    loss = ((out.color * _t(wc)).sum() + (out.depth * _t(wd)).sum()
            + (torch.exp(out.log_t) * _t(wt)).sum())
    loss.backward()
    assert gsl.LAUNCHES == before      # CPU tensors take the plain versions
    np.testing.assert_allclose(float(loss.detach()), jax_ref["loss"],
                               rtol=1e-5)
    dg, dr = np_of(g.grad), np_of(r.grad)
    # the JAX suite's Gaussian-parameter gradient tolerance
    np.testing.assert_allclose(dg, np.asarray(gj), atol=5e-3, rtol=1e-2)
    np.testing.assert_allclose(dr, np.asarray(rj), atol=5e-3, rtol=1e-2)
    lane = np.arange(CAP)[None, :]
    past = lane >= COUNTS[:, None]
    # lanes past the count, and the valid and pad rows, are exactly zero
    assert (dg.transpose(1, 0, 2)[:, past] == 0).all()
    assert (dr.transpose(1, 0, 2)[:, past] == 0).all()
    assert (dg[:, 6:] == 0).all()
    assert np.abs(dg[2]).max() > 0 and np.abs(dr[5]).max() > 0


def test_cuda_wrapper_rejects_bad_inputs(windows):
    geom, rgbd = (_t(a) for a in windows)
    counts = _t(COUNTS)
    with pytest.raises(ValueError, match="CUDA tensors"):
        pb.pregathered_blend_fwd_cuda(counts, geom, rgbd, GRID_X, 16, CHUNK)
    with pytest.raises(ValueError, match="tile_size"):
        pb.pregathered_blend_fwd_cuda(counts, geom, rgbd, GRID_X, 8, CHUNK)
    with pytest.raises(ValueError, match="unsupported device"):
        pb.pregathered_blend_fwd(counts, geom.to("meta"), rgbd, GRID_X, 16,
                                 CHUNK)


def test_float64_plain_matches_float32_and_pallas(windows, jax_ref):
    """The float64 plain K3/K4, the yardstick the card's kernels are read
    against, agree with the float32 plain versions and with the Pallas
    kernels at this file's tolerances."""
    geom, rgbd = (_t(a) for a in windows)
    counts = _t(COUNTS)
    wc, wd, wt = (_t(a) for a in _weights())
    outs = {}
    for dt in (torch.float32, torch.float64):
        acc, logt, resid = pb.pregathered_blend_fwd_plain(
            counts, geom, rgbd, GRID_X, 16, CHUNK, dtype=dt)
        assert acc.dtype == logt.dtype == resid.dtype == dt
        # the test loss's cotangents: color, depth, and T = exp(log_t)
        gacc = torch.cat([wc.transpose(1, 2), wd[:, None, :]], 1).to(dt)
        glogt = (wt.to(dt) * torch.exp(logt[..., 0]))[..., None]
        dg, dr = pb.pregathered_blend_bwd_plain(
            counts, geom, rgbd, gacc, glogt, GRID_X, 16, CHUNK, dtype=dt)
        assert dg.dtype == dr.dtype == dt
        outs[dt] = [np_of(x) for x in (acc, logt, resid, dg, dr)]
    f32, f64 = outs[torch.float32], outs[torch.float64]
    acc_j, logt_j, resid_j = jax_ref["fwd"]
    for ref in (f32[:3], (acc_j, logt_j, resid_j)):
        for x, y in zip(f64[:2], ref[:2]):
            np.testing.assert_allclose(x, y, atol=3e-5, rtol=3e-5)
        np.testing.assert_allclose(f64[2][..., 0], ref[2][..., 0], atol=3e-5,
                                   rtol=3e-5)
        np.testing.assert_array_equal(f64[2][..., 1], ref[2][..., 1])
    for ref in (f32[3:], (jax_ref["dgeom"], jax_ref["drgbd"])):
        for x, y in zip(f64[3:], ref):
            np.testing.assert_allclose(x, y, atol=5e-3, rtol=1e-2)
    # float32 in, float32 out: the default computes what it always did
    ref32 = pb.pregathered_blend_fwd_plain(counts, geom, rgbd, GRID_X, 16,
                                           CHUNK)
    for x, y in zip(ref32, f32[:3]):
        np.testing.assert_array_equal(np_of(x), y)


def test_tile_order_is_stable_descending_permutation():
    # a count past the cap or below 0 is clamped, as the kernels clamp it
    counts = torch.tensor([5, 0, 7, 5, 3000, 7, -4, 1, 2560],
                          dtype=torch.int32)
    order = pb.tile_order(counts, 2560)
    assert order.dtype == torch.int32
    assert sorted(order.tolist()) == list(range(len(counts)))
    # deepest first; ties keep the tile order
    assert order.tolist() == [4, 8, 2, 5, 0, 3, 7, 1, 6]
    assert pb.tile_order(torch.zeros(0, dtype=torch.int32), 8).numel() == 0
