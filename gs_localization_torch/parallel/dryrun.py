"""N-process dryrun of the multi-device layer on ``torch.distributed``.

    python -m gs_localization_torch.parallel.dryrun [--nproc 2]
        [--device cuda|cpu]

Launches N gloo ranks on localhost, each its own process, all on the card
``cuda:0`` (the default: NCCL refuses two ranks on one device, gloo does
not) or, with ``--device cpu``, on the CPU, and in each runs, on the JAX
dryrun's tiny scene:

1. ``dp.dryrun_train_step(N)``: a DP step, a (data, gauss) mesh's loss and
   gradients (N even) and a tile-sharded render;
2. a DP training step over a global batch of N x 2 cameras, of
   which each rank materializes only its own block
   (``runtime.host_local_slice``, ``runtime.make_global_batch``): the DP
   loss equals the single-process loss of the whole batch within 1e-5;
3. query-parallel localization (``dp.shard_queries_refine``, 3 iterations)
   over the same batch: the all-gathered refined poses match
   single-process refinement within 2 x lr x iterations (Adam normalizes
   each tangent component, so rounding flips of near-zero gradients move a
   pose by O(lr) per iteration, while a query routed to the wrong rank
   would be O(1e-1) off), and the final losses within rtol 0.1, atol 1e-4.

Each rank prints one OK line, then the launcher prints ``ALL OK``. Ranks
exit non-zero on a failed check; the launcher exits non-zero if any rank
did. The counterpart of the JAX package's
``benchmarks/dryrun_multiprocess.py``.
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys

import numpy as np

_TIMEOUT_S = 600
PER_RANK = 2        # cameras (and queries) of each rank's block


def worker(rank: int, nproc: int, port: int, device: str) -> None:
    import torch

    from ..loc.refine import TrackingConfig, refine_poses_batch
    from ..mapping import losses
    from ..raster import rasterize
    from . import dp, runtime

    torch.set_num_threads(1)
    if not runtime.initialize_runtime(f"127.0.0.1:{port}", nproc, rank,
                                      backend="gloo"):
        raise RuntimeError("the dryrun needs at least 2 processes")
    dev = runtime.rank_device(device)

    dp.dryrun_train_step(nproc, dev)

    n_global = nproc * PER_RANK
    mesh = runtime.global_mesh(("data",))
    g = dp.tiny_scene(n=128, sh_degree=1, seed=1, device=dev)
    cfg = dp.DRYRUN_CFG
    # every rank draws the same global batch and keeps its own block as its
    # data; the whole batch serves the single-process references only
    cams_all, imgs_all = dp.dryrun_cameras(n_global, dev)
    lo, hi = runtime.host_local_slice(n_global, mesh)
    imgs = runtime.make_global_batch(imgs_all[lo:hi], mesh, device=dev)
    cams = cams_all[lo:hi]

    # ---- 1. DP training step across ranks ---------------------------------
    loss, grads = dp.dp_train_grads(mesh, g, cams, imgs, cfg)
    loss = float(loss)
    with torch.no_grad():
        ref_loss = float(np.mean([
            float(losses.training_loss(rasterize(g, c, cfg).color, im)[0])
            for c, im in zip(cams_all, imgs_all)]))
    if abs(loss - ref_loss) >= 1e-5:
        raise RuntimeError(f"DP loss {loss} != single-process {ref_loss}")
    if not all(bool(torch.isfinite(v).all()) for v in grads.values()):
        raise RuntimeError("DP gradients not finite")

    # ---- 2. query-parallel localization across ranks ----------------------
    with torch.no_grad():
        targets = torch.stack([rasterize(g, c, cfg).color for c in cams_all])
    masks = torch.ones(targets.shape[:3], dtype=torch.bool, device=dev)
    tcfg = TrackingConfig(num_iters=3, lr=1e-3, convergence=0.0,
                          monocular=True)
    res = dp.shard_queries_refine(mesh, g, cams, targets[lo:hi], masks[lo:hi],
                                  tcfg, cfg)
    ref = refine_poses_batch(g, cams_all, targets, masks, tcfg, cfg)
    diff = float((res.w2c - ref.w2c).abs().max())
    if diff >= 2.0 * tcfg.lr * tcfg.num_iters:
        raise RuntimeError(f"all-gathered poses {diff:.3e} from the "
                           "single-process refinement")
    np.testing.assert_allclose(res.final_loss.cpu().numpy(),
                               ref.final_loss.cpu().numpy(), rtol=0.1,
                               atol=1e-4)
    print(f"dryrun_multiprocess: p{rank}/{nproc} (gloo, {dev}) - DP "
          f"loss {loss:.4f} == single-process {ref_loss:.4f}; {n_global} "
          f"queries refined, all-gathered pose diff {diff:.2e} ok",
          flush=True)
    torch.distributed.destroy_process_group()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(nproc: int, device: str) -> int:
    """Run the dryrun in ``nproc`` ranks; prints their OK lines (or the
    end of a failed rank's output) and returns 0 when every rank passed.
    Raises at once for ``device="cuda"`` without a card."""
    from .. import resolve_device

    resolve_device(device)
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", __spec__.name, "--worker", str(i), "--nproc",
         str(nproc), "--port", str(port), "--device", device],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i in range(nproc)]
    rc = 0
    try:
        for p in procs:
            out, _ = p.communicate(timeout=_TIMEOUT_S)
            ok = [ln for ln in out.splitlines()
                  if ln.startswith(("dryrun_multiprocess:",
                                    "dryrun_multichip:"))]
            print("\n".join(ok) if p.returncode == 0 else out[-3000:],
                  flush=True)
            rc |= p.returncode
    finally:
        for p in procs:         # a rank left waiting on a failed peer
            if p.poll() is None:
                p.kill()
                p.wait()
    if rc == 0:
        print(f"dryrun_multiprocess: ALL OK ({nproc} processes, gloo, "
              f"{device})", flush=True)
    return rc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nproc", type=int, default=2)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--worker", type=int, default=None)
    ap.add_argument("--port", type=int, default=0)
    args = ap.parse_args(argv)
    if args.worker is not None:
        worker(args.worker, args.nproc, args.port,
               "cuda:0" if args.device == "cuda" else "cpu")
        return 0
    return launch(args.nproc, args.device)


if __name__ == "__main__":
    sys.exit(main())
