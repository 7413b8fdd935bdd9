"""Host utilities of the port: PFM files, disparity colouring, forward
latency and the training metric logger."""
