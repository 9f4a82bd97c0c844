"""Pose refinement: gradient descent on an SE(3) delta against a 3DGS map."""

from .refine import (TrackingConfig, refine_pose, refine_poses_batch,
                     tracking_loss)
