"""Port PLY I/O against the JAX package: maps written by either load in the
other with the same fields."""

import numpy as np
import pytest

from gs_localization_tpu.data.ply import (
    load_gaussian_ply as j_load, save_gaussian_ply as j_save)
from gs_localization_torch.core.gaussians import FIELDS
from gs_localization_torch.data.ply import load_gaussian_ply, save_gaussian_ply
from gs_localization_torch.pipelines.localize import load_map
from helpers import random_scene
from torch_bridge import gaussians_to_torch


def _assert_same(tg, jg):
    assert (tg.sh_degree, tg.max_sh_degree) == (jg.sh_degree,
                                                jg.max_sh_degree)
    got = tg.to_numpy()
    for f in FIELDS:
        np.testing.assert_array_equal(got[f], np.asarray(getattr(jg, f)),
                                      err_msg=f)


@pytest.mark.parametrize("sh_degree", [0, 3])
def test_jax_written_map_loads_in_port(tmp_path, sh_degree):
    g = random_scene(np.random.default_rng(sh_degree), 50,
                     sh_degree=sh_degree, capacity=64)
    path = str(tmp_path / "map.ply")
    j_save(path, g)
    _assert_same(load_gaussian_ply(path, capacity=64, device="cpu"),
                 j_load(path, capacity=64))
    _assert_same(load_map(path, device="cpu"), j_load(path))


def test_port_written_map_loads_in_jax(tmp_path):
    g = random_scene(np.random.default_rng(7), 40, sh_degree=2, capacity=48)
    path = str(tmp_path / "map.ply")
    save_gaussian_ply(path, gaussians_to_torch(g))
    jg = j_load(path, capacity=48)
    _assert_same(load_gaussian_ply(path, capacity=48, device="cpu"), jg)
    # the live Gaussians survive the round trip unchanged
    live = np.asarray(g.live)
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(jg, f))[live],
                                      np.asarray(getattr(g, f))[live],
                                      err_msg=f)


def test_rejects_what_it_cannot_read(tmp_path):
    path = tmp_path / "bad.ply"
    path.write_bytes(b"ply\nformat ascii 1.0\nend_header\n")
    with pytest.raises(ValueError, match="format"):
        load_gaussian_ply(str(path), device="cpu")
    path.write_bytes(b"not a ply")
    with pytest.raises(ValueError, match="not a PLY"):
        load_gaussian_ply(str(path), device="cpu")
