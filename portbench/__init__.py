"""The benchmark of the PyTorch and CUDA port (``src/repro_torch``): its
harness, configurations, traffic mixes, per-layer metric readers, plain
references and limits.  ``python3 portbench/run.py --help`` runs a cell;
``BENCHMARK.json`` at the repository's root lists them."""
