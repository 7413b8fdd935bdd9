"""mfu.stream: ``readers.mfu_service_pct``."""

from stereobench.readers import mfu_service_pct as read  # noqa: F401
