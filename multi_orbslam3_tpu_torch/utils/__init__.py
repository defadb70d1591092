"""Cross-cutting helpers (copies of the JAX package's numpy-only modules)."""
