"""Serving: the single-request ``InferenceEngine`` and samplers."""
