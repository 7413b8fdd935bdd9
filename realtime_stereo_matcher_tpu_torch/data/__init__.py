"""Data for training (port of ``realtime_stereo_matcher_tpu/data/``): so far
the procedural synthetic scenes only."""
