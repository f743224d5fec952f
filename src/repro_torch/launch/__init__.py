"""Launch layer: serving and its lowered entry points."""
