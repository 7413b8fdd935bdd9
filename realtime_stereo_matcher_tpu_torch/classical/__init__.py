"""The classical SGBM baseline of the port (``classical/sgbm.py``)."""
