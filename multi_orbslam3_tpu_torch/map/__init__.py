"""Fixed-capacity device-resident map store (struct of tensors)."""
