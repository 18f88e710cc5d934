"""Offline tokenizer and MMLU-style prompt generator (copies of
``repro.data``)."""
