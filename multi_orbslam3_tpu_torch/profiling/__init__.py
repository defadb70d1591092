"""Profilers of the port on the card (counterparts of the JAX package's
``profiling/profile_*.py``): ``profile_stages`` (one call of each pipeline
stage on a mature map), ``profile_mono`` (wall-time buckets of the mono
loop, and a device trace of a window of frames of any loop),
``profile_ab_u8`` (uint8 against float32 frame upload), ``profile_scatter``
(local-BA assembly: index_add against one-hot matmuls) and
``profile_covis`` (covisibility formulations). Each runs as
``python -m multi_orbslam3_tpu_torch.profiling.<name>``, prints one JSON
line, and runs on the card unless a ``device`` is given; ``common`` holds
the timers and the trace reader."""
