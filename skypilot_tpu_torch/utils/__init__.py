"""Small host-side helpers of the port (registry, device selection)."""
