"""The train state, hooks and loop."""
