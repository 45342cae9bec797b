"""The benchmark of ``pinn_torch`` on one NVIDIA H100: training cells of
the continuous-time Schrödinger PINN, each run found by
name in ``BENCHMARK.json`` (``portbench/harness.py``)."""
