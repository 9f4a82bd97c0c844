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


def test_plain_forward_matches_pallas(windows):
    geom, rgbd = windows
    fwd_call, _ = jpb._make_core_calls(GRID_X * GRID_Y, GRID_X, 16, CAP,
                                       CHUNK, True)
    acc_j, logt_j, resid_j = fwd_call(jnp.asarray(COUNTS), jnp.asarray(geom),
                                      jnp.asarray(rgbd))
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


def test_vjp_matches_pallas(windows):
    geom, rgbd = windows
    rng = np.random.default_rng(1)
    npix = 256
    wc = rng.standard_normal((6, npix, 3)).astype(np.float32)
    wd = rng.standard_normal((6, npix)).astype(np.float32)
    wt = rng.standard_normal((6, npix)).astype(np.float32)

    def jloss(g, r):
        out = jpb.blend_pregathered_pallas(jnp.asarray(COUNTS), g, r, GRID_X,
                                           16, chunk=CHUNK, interpret=True)
        return (jnp.sum(out.color * wc) + jnp.sum(out.depth * wd)
                + jnp.sum(jnp.exp(out.log_t) * wt))

    gj, rj = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(geom),
                                             jnp.asarray(rgbd))
    g, r = _t(geom).requires_grad_(), _t(rgbd).requires_grad_()
    before = dict(gsl.LAUNCHES)
    out = pb.blend_pregathered_pallas(_t(COUNTS), g, r, GRID_X, 16,
                                      chunk=CHUNK)
    loss = ((out.color * _t(wc)).sum() + (out.depth * _t(wd)).sum()
            + (torch.exp(out.log_t) * _t(wt)).sum())
    loss.backward()
    assert gsl.LAUNCHES == before      # CPU tensors take the plain versions
    np.testing.assert_allclose(float(loss.detach()),
                               float(jloss(jnp.asarray(geom),
                                           jnp.asarray(rgbd))), rtol=1e-5)
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
