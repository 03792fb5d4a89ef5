"""Image output and comparison metrics."""
