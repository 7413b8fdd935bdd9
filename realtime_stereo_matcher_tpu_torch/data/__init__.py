"""Data of the port (port of ``realtime_stereo_matcher_tpu/data/``): the
procedural synthetic scenes, and the dataset readers and frame IO that
evaluation reads."""
