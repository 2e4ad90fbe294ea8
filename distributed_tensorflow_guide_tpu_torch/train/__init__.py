"""The train state, hooks, loop and held-out evaluation."""
