"""Environment knobs and benchmark harness."""
