"""Host utilities of the port: PFM and PNG files, disparity colouring,
forward latency, the training metric logger, the g++ build of the native
SGBM and the profiler (capacity, FLOPs, traces, spans)."""
