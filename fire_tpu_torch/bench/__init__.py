"""The port's measurement plane: ``python -m fire_tpu_torch.bench
{headline,gallery,tracker,crowd,profile}``.

Each subcommand mirrors one JAX script of the repository (``bench.py``,
``bench_gallery.py``, ``bench_tracker.py``, ``tools/bench_crowd.py``,
``tools/profile_step.py``), prints that script's one JSON line with its
keys on stdout, and runs on the card unless ``--device cpu`` is given.
"""
