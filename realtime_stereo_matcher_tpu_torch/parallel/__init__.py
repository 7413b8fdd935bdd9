"""Training and inference across processes (port of
``realtime_stereo_matcher_tpu/parallel/``): the process group, the mesh's
``data``, ``spatial`` and ``disp`` axes, data-parallel training, the
collective audit and the scaling bench, and sharded inference (row halos in
``halo.py``, the disparity-sharded cost volume in ``disparity_sharding.py``,
the staged forward in ``sharded_infer.py``)."""
