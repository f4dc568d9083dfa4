"""Stage-2 inference wrapper and its text tokenizer."""
