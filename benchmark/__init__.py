"""The benchmark of ptudes_tpu_torch on one CUDA card: ``run.py`` runs one
cell of ``BENCHMARK.json`` once (see ``README.md``)."""
