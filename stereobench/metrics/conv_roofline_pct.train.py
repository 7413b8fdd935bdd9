"""conv_roofline_pct.train: ``readers.conv_roofline_pct``."""

from stereobench.readers import conv_roofline_pct as read  # noqa: F401
