"""Host-side utilities: run directories, dataset configs, checkpoints."""
