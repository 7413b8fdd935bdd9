"""Data-parallel training across processes (port of
``realtime_stereo_matcher_tpu/parallel/``): the process group, the mesh's
``data`` axis, the collective audit and the scaling bench.  Sharded
inference is not ported yet (ROADMAP.md)."""
