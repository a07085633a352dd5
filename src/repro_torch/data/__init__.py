"""The deterministic synthetic data of LM training."""
