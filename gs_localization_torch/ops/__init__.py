"""Image ops for tracking masks."""
