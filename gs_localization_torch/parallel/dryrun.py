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
did, or if the ranks outlast ``_TIMEOUT_S``, and then prints the end of
every rank's output. The ranks meet through a store file in a fresh
temporary directory (``runtime.local_rendezvous``), not a port. The
counterpart of the JAX package's ``benchmarks/dryrun_multiprocess.py``.

``start_ranks`` and ``wait_ranks`` are the launcher's two halves, for any
program that starts ranks on this host (the tests, ``chip_smoke.py``).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np

_TIMEOUT_S = 600
PER_RANK = 2        # cameras (and queries) of each rank's block


def worker(rank: int, nproc: int, init: str, device: str) -> None:
    import torch

    from ..loc.refine import TrackingConfig, refine_poses_batch
    from ..mapping import losses
    from ..raster import rasterize
    from . import dp, runtime

    torch.set_num_threads(1)
    if not runtime.initialize_runtime(init, nproc, rank, backend="gloo"):
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
    runtime.shutdown_runtime()


def start_ranks(argvs: Sequence[Sequence[str]], log_dir,
                **popen_kw) -> List[subprocess.Popen]:
    """One process per argv, its stdout and stderr written to
    ``log_dir/rank{i}.log``: a file, so that no rank blocks on output that
    nobody reads while another rank is waited on."""
    procs = []
    for i, argv in enumerate(argvs):
        with open(os.path.join(log_dir, f"rank{i}.log"), "w") as log:
            procs.append(subprocess.Popen(list(argv), stdout=log,
                                          stderr=subprocess.STDOUT, text=True,
                                          **popen_kw))
        procs[-1].log_path = log.name
    return procs


def wait_ranks(procs: Sequence[subprocess.Popen],
               timeout: float) -> List[Tuple[Optional[int], str]]:
    """Wait for the processes of ``start_ranks`` up to ``timeout`` seconds.
    A rank that fails ends the wait, since its peers would wait for it up
    to the runtime's own timeout: every rank still running is then killed,
    as it is at the deadline. Returns each rank's exit code (None: killed)
    and all that it printed."""
    deadline = time.monotonic() + timeout
    try:
        while time.monotonic() < deadline:
            rcs = [p.poll() for p in procs]
            if None not in rcs or any(rc not in (None, 0) for rc in rcs):
                break
            time.sleep(0.05)
    finally:
        killed = [p.poll() is None for p in procs]
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    out = []
    for p, k in zip(procs, killed):
        with open(p.log_path) as f:
            out.append((None if k else p.returncode, f.read()))
    return out


def rank_tails(results: Sequence[Tuple[Optional[int], str]],
               n: int = 3000) -> str:
    """Every rank's exit code and the last ``n`` characters it printed."""
    return "\n".join(
        f"--- rank {i}: " + ("killed (timed out or its peer failed)"
                             if rc is None else f"exit {rc}")
        + f" ---\n{out[-n:]}" for i, (rc, out) in enumerate(results))


def launch(nproc: int, device: str) -> int:
    """Run the dryrun in ``nproc`` ranks; prints their OK lines (or every
    rank's exit code and the end of its output) and returns 0 when every
    rank passed. Raises at once for ``device="cuda"`` without a card."""
    from .. import resolve_device
    from . import runtime

    resolve_device(device)
    with tempfile.TemporaryDirectory(prefix="gsloc_dryrun_") as tmp:
        init = runtime.local_rendezvous(tmp)
        results = wait_ranks(start_ranks(
            [[sys.executable, "-m", __spec__.name, "--worker", str(i),
              "--nproc", str(nproc), "--init", init, "--device", device]
             for i in range(nproc)], tmp), _TIMEOUT_S)
    if any(rc != 0 for rc, _ in results):
        print(rank_tails(results), flush=True)
        return 1
    for _, out in results:
        print("\n".join(ln for ln in out.splitlines() if ln.startswith(
            ("dryrun_multiprocess:", "dryrun_multichip:"))), flush=True)
    print(f"dryrun_multiprocess: ALL OK ({nproc} processes, gloo, "
          f"{device})", flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nproc", type=int, default=2)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--worker", type=int, default=None)
    ap.add_argument("--init", default=None,
                    help="the world's rendezvous address (a worker's)")
    args = ap.parse_args(argv)
    if args.worker is not None:
        worker(args.worker, args.nproc, args.init,
               "cuda:0" if args.device == "cuda" else "cpu")
        return 0
    return launch(args.nproc, args.device)


if __name__ == "__main__":
    sys.exit(main())
