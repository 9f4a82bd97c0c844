"""End-to-end pipelines: ``train_map`` (map training from a scene),
``localize`` (batched pose refinement against a trained map from initial
poses), ``render_eval`` (renders and their metrics), and the scene runner
``run_scene`` that chains prepare, sfm, train and localize.

The function ``train_map`` is not re-exported here, as the JAX package
does: the name would hide the submodule ``pipelines.train_map``."""

from .train_map import TrainPipelineConfig
from .localize import LocalizePipelineConfig, localize_queries
from .render_eval import render_and_eval
