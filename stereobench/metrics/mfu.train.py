"""mfu.train: ``readers.mfu_pct``."""

from stereobench.readers import mfu_pct as read  # noqa: F401
