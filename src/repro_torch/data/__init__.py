"""Token data for training: the deterministic, prefetching pipeline."""
