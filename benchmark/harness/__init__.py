"""The benchmark's harness: discovery of cells by name, the timed window,
the trace reduction, the metric arithmetic and the correctness check.
It knows no cell, configuration, scene or metric by name."""
