"""Device resolution, the process group's bootstrap, the process mesh,
precision."""
