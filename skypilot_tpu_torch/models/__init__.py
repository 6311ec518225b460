"""Model code of the port: configs, llama math, paged decode, weights."""
