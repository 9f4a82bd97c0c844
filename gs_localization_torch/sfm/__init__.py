"""SfM / retrieval / PnP initialization front end, on the port.

The reference drives this stage through hloc + pycolmap: SuperPoint/SuperGlue
feature matching, NetVLAD retrieval, and PnP-RANSAC initial poses. The
classical front end, which needs no weights:

- ``features`` / ``sift``: Harris and DoG/rootSIFT keypoints, the tiny-image
                  global descriptor (on the device of the image tensor).
- ``matching``  : mutual nearest neighbours with the ratio test.
- ``retrieval`` : global-descriptor top-k retrieval (one matrix product).
- ``pairs`` / ``triangulate``: pair lists, epipolar verification, tracks,
                  known-pose DLT triangulation, RGB-D depth correction.
- ``pnp``       : native PnP-RANSAC (DLT hypotheses + Gauss-Newton polish),
                  replacing pycolmap.absolute_pose_estimation for init poses.
- ``bundle_adjust`` / ``incremental``: matrix-free LM bundle adjustment and
                  incremental SfM with unknown poses, replacing
                  pycolmap.incremental_mapping.
- ``adalam`` / ``match_dense``: AdaLAM match filtering, dense-match
                  aggregation.
- ``superpoint`` / ``superglue`` / ``netvlad``: the learned front end
                  (SuperPoint features, SuperGlue matching, NetVLAD
                  retrieval) as ``nn.Module``s on an explicit device.
- ``lightglue`` / ``loftr``: LightGlue matching and the LoFTR dense
                  matcher.
- ``d2net`` / ``r2d2`` / ``disk``: the D2-Net, R2D2 and DISK extractors.
- ``dir`` / ``openibl`` / ``eigenplaces``: the DIR, OpenIBL and
                  EigenPlaces / CosPlace global descriptors.
- ``weights`` / ``registry``: the official checkpoint manifest and loader,
                  and hloc's conf names -> extractors, matchers, global
                  descriptors.
- ``evaluate``  : the reference's median / threshold-recall pose metrics.
- ``io``        : results files (name qw qx qy qz tx ty tz) and query lists
                  with intrinsics — interop with existing hloc artifacts.

The networks' convolutions and matmuls are library calls (cuDNN, cuBLAS)
held to float32. The host-side parts (pairs, tracks, triangulation, PnP, the mapper, AdaLAM,
dense aggregation) are numpy copies of the JAX package's and give the same
bits for the same inputs and seeds.
"""

from .pnp import pnp_ransac
from .retrieval import top_k_retrieval
from .evaluate import pose_errors, summarize_errors, THRESHOLDS
from .io import (read_pose_results, write_pose_results,
                 read_query_list_with_intrinsics)
from .bundle_adjust import BAProblem, bundle_adjust, bundle_adjust_np
from .incremental import (
    Reconstruction, decompose_essential, essential_ransac,
    incremental_mapping,
)
from .evaluate import umeyama_alignment
from .superglue import (
    SuperGlueNet, load_superglue, matches_as_pairs, superglue_from_jax_params,
    superglue_match,
)
from .superpoint import (
    SuperPointNet, extract_superpoint, load_superpoint,
    superpoint_from_jax_params,
)
from .netvlad import NetVLAD, load_netvlad_mat, netvlad_descriptor
