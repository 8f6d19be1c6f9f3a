"""The benchmark's yardstick: inputs and weights from a seed, operation
counts and peaks, the trace's reduction and the compared numbers."""
