"""slambench: the benchmark of the PyTorch and CUDA port
(``multi_orbslam3_tpu_torch``). ``python3 -m slambench.run --workload <cell>
--seed <n> --seconds <s> --trace <0|1>`` runs one cell of BENCHMARK.json
once and prints one JSON line. Nothing here imports the JAX package."""
