"""The benchmark of slate_tpu_torch, the PyTorch / CUDA port, on NVIDIA cards.

One command runs one cell of ``BENCHMARK.json`` once::

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, traffic mix, metric, driver
entry, matrix generator, roofline count or launcher is a file of its own,
found by the name that ``BENCHMARK.json`` or the configuration gives it
(``registry.py``). Nothing here imports ``jax``, ``jaxlib`` or the JAX
package ``slate_tpu``; ``reference/`` imports nothing of the port either.
"""
