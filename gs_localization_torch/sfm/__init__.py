"""Pose-error metrics of the reference's evaluation protocol."""
