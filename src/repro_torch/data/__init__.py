"""Token data pipeline."""
