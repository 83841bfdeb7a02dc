"""The harness: cells by name, the run, the trace arithmetic, the comparison."""
