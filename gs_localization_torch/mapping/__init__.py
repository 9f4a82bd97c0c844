"""3DGS map training: losses, per-group Adam, densification, train step."""

from .densify import densify_and_prune, reset_opacity
from .losses import l1_loss, l2_loss, pearson_depth_loss, training_loss
from .train import MapTrainConfig, MapTrainState, init_training, train_step
