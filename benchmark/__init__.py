"""The benchmark of ``mlff_tpu_torch`` on one NVIDIA H100, or four for a
cell that asks for them (``ranks.py``).

One command runs one cell once (see ``README.md``):

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything the benchmark measures with is frozen here: the data generator
(``data.py``), the peaks and the operation and byte counts (``peaks.py``),
the reading of the profiler's trace (``devtrace.py``) and the plain
reference that decides ``correct`` (``reference.py``).  Nothing here
imports the JAX package or JAX; the program is reached only through its
user entries (``create_task``, ``Trainer.train``, ``Predictor.predict``),
and the per-layer readers that time a layer alone.
"""
