"""Per-step communication volume of the data-parallel port (port of
``realtime_stereo_matcher_tpu/parallel/comm_audit.py``).

The JAX package's collectives are inserted by XLA's SPMD partitioner, so it
parses the compiled HLO for them (``collective_inventory``).  The port
issues its collectives itself, through ``parallel/distributed.py``, whose
recorder sees every one: :func:`audit` runs a function once under it and
totals the bytes by op kind.  The HLO parser has no counterpart here.

:func:`ring_wire_bytes` turns a payload into the per-rank wire traffic of a
ring collective, a copy of the JAX package's.
"""

from __future__ import annotations

from realtime_stereo_matcher_tpu_torch.parallel.distributed import (
    CollectiveRecorder,
)


def audit(fn, *args, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` once and total the collectives it issued
    through ``parallel/distributed.py``, backward passes included.

    Returns {"per_op": {op: {"count", "bytes"}}, "per_what": {what:
    {"count", "bytes"}}, "total_bytes": N, "inventory": [...], "result":
    fn's return value}; ``bytes`` are payloads (one rank's buffer)."""
    with CollectiveRecorder() as rec:
        result = fn(*args, **kwargs)
    per_op: dict = {}
    per_what: dict = {}
    for item in rec.records:
        for table, key in ((per_op, item["op"]), (per_what, item["what"])):
            slot = table.setdefault(key, {"count": 0, "bytes": 0})
            slot["count"] += 1
            slot["bytes"] += item["bytes"]
    return {"per_op": per_op, "per_what": per_what,
            "total_bytes": sum(i["bytes"] for i in rec.records),
            "inventory": rec.records, "result": result}


def ring_wire_bytes(payload_bytes: int, op: str, n: int) -> float:
    """Per-chip wire traffic of one collective on an n-device ring."""
    if n <= 1:
        return 0.0
    if op == "all-reduce":
        return 2.0 * payload_bytes * (n - 1) / n
    if op in ("all-gather", "reduce-scatter"):
        # payload of an all-gather result is the FULL gathered buffer; each
        # chip receives (n-1)/n of it (and sends its own 1/n shard n-1 times)
        return payload_bytes * (n - 1) / n
    if op == "collective-permute":
        return float(payload_bytes)
    if op == "all-to-all":
        return payload_bytes * (n - 1) / n
    return float(payload_bytes)
