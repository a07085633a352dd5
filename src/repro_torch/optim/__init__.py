"""The optimizer of LM training (``repro.optim``'s AdamW)."""
