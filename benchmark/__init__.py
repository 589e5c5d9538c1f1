"""The benchmark of `unet_research_tpu_torch` on NVIDIA H100 cards: one run
of one cell of BENCHMARK.json per call of run.py. It imports the port and
nothing of the JAX package."""
