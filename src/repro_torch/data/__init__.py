"""Data: the byte tokenizer and the deterministic batch pipeline."""
