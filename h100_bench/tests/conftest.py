"""The small sizes of configurations added after ``small.py``'s
``SMALL`` was written, registered before any test of this folder runs, so
that every cell of ``BENCHMARK.json`` builds small (``test_spec.py``)."""

from h100_bench.tests.small import SMALL

SMALL.setdefault("two_stage", {"darknet_input": 64, "n_grid": 2,
                               "batch_size": 4, "max_crops": 2})
