"""The benchmark's yardstick: the card's peaks, the operation and byte
counts of kernels and models, the reduction of a profiler trace, and the
statistics. Later changes to the program are measured against these."""
