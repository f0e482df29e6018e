"""One reader per metric of ``BENCHMARK.json``, found by the metric's
name: ``perfbench/metrics/<name>.py`` defines ``read(run)``, which takes
the run's records (``harness.Run``) and returns the metric's value, or
None where the run has nothing to read, in which case the metric is left
out of the result line."""
