"""Server-side declarations of the port (the inference metric split)."""
