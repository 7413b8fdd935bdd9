"""Data of the port (port of ``realtime_stereo_matcher_tpu/data/``): the
procedural synthetic scenes, the dataset readers and frame IO, the host
augmentors and threaded loader, and the device-resident scenes and their
augmentation on the card."""
