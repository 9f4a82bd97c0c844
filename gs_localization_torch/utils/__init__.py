"""Shared utilities: config loading, metrics logging, profiling, a web viewer."""

from .config import load_config, merge_config
