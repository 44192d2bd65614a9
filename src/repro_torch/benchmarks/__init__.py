"""The paper-table benchmarks of the port: one module per table or figure,
each a port of the reference's ``benchmarks/bench_<name>.py`` with its
protocol and ``fast`` lists (``run.py`` lists them)."""
