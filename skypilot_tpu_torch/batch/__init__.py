"""Batch inference: the JSONL mapper over the batch ``InferenceEngine``."""
