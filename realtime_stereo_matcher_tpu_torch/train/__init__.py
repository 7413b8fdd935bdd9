"""Training: loss, optimizer, train-start init, BatchNorm freezing and the
trainer (port of ``realtime_stereo_matcher_tpu/train/``)."""
