"""Training checkpoints (save, restore) and fault tolerance (watchdog, fault injection, restarts)."""
