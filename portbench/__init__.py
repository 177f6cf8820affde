"""portbench: the benchmark of the PyTorch and CUDA port (``uegan_tpu_torch``).

``run.py`` runs one cell of ``BENCHMARK.json`` once.  What belongs to one
configuration, traffic mix, per-layer metric or cell sits in files of its
own, found by name: ``configs/``, ``traffic/`` (data, read by the general
``drivers/``), ``layer_metrics/``, ``limits/``; ``counts/`` holds the work
each path and kernel must do, ``reference/`` the plain float32 model the
outputs are held to, ``harness/`` what every run shares.  Nothing here
imports JAX or the JAX package; the reference imports nothing of the port.
"""
