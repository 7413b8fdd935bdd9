"""Host utilities of the port: PFM files, disparity colouring and forward
latency."""
