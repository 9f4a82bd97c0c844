"""Multi-device sharding on ``torch.distributed``.

One rank owns one device, PyTorch's model. The JAX package's ``shard_map``
bodies become the per-rank functions here, and its ``pmean`` / ``psum`` /
``all_gather`` become explicit collectives on the sub-group of one mesh
axis (``runtime.Mesh``). Three parallel axes, composable on an N-D mesh:

- ``data``  : cameras (map training) / queries (localization) shard across
  ranks, Gaussians replicated, gradients averaged (dp.py).
- ``gauss`` : the map itself shards across ranks; one all-gather of the
  screen-space splats per render, owner-computes backward with no
  gauss-axis collective (gauss_shard.py).
- ``tile``  : one frame's tile grid shards across ranks; the forward gathers
  the tiles' outputs, per-Gaussian gradients are summed over the ranks in
  the backward (tile_shard.py).
- ``runtime`` : process bring-up (``init_process_group``, a store file for
  ranks on one host) and shutdown, meshes of process groups, per-rank
  data (runtime.py); ``dryrun`` starts and waits for ranks on one host.

Submodules are re-exported lazily (PEP 562): ``import
gs_localization_torch.parallel`` creates no process group and does not
initialise CUDA.
"""

_EXPORTS = {
    "dp_train_grads": "dp",
    "dryrun_train_step": "dp",
    "make_mesh": "dp",
    "shard_queries_refine": "dp",
    "gauss_sharded_loss_and_grads": "gauss_shard",
    "make_mesh_2d": "gauss_shard",
    "rasterize_gauss_sharded": "gauss_shard",
    "rasterize_tile_sharded": "tile_shard",
    "runtime": None,
    "dp": None,
    "gauss_shard": None,
    "tile_shard": None,
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    import importlib

    if name not in _EXPORTS:
        raise AttributeError(name)
    mod_name = _EXPORTS[name] or name
    mod = importlib.import_module(f".{mod_name}", __name__)
    return mod if _EXPORTS[name] is None else getattr(mod, name)
