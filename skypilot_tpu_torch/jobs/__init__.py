"""Jobs of the port (the RL rollout pipeline)."""
