"""Launch layer: training and serving, and their entry points."""
