"""The benchmark's harness: cells resolved by name from ``BENCHMARK.json``
(``spec``), the scene (``scene``), the run (``driver``), the arithmetic of
its metrics (``stats``, ``flops``), the profiler's reading (``trace``) and
the comparison with the plain reference (``check``)."""
