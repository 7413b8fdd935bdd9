"""The benchmark of realtime_stereo_matcher_tpu_torch (README.md)."""
