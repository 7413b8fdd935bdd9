"""Training: loss, optimizer, train-start init and the trainer (port of
``realtime_stereo_matcher_tpu/train/``)."""
