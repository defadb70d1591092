"""The port's entry scripts (counterparts of the repository's apps/),
each run as ``python -m multi_orbslam3_tpu_torch.apps.<name>``. They take
the JAX apps' arguments and write the same outputs, plus ``--device``
(default: the CUDA device; ``--device cpu`` runs on the CPU)."""
