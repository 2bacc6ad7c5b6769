"""Per-collective communication digest (port of ``deepspeed_tpu/comm/
digest.py``; ref: deepspeed/comm/comm.py ``comms_logger``).

The JAX package reads its collectives from the compiled step's HLO, since
GSPMD places them.  In the port every collective is a call the engine
makes, recorded by the process's :class:`~deepspeed_tpu_torch.utils.trace.
CommsLogger`, so a digest is the logger's totals over one step: each
record's op maps onto the JAX package's kind names (a host-staged call,
``op:host``, counts as its op), and ``bytes`` is this rank's payload of
the calls, the logger's count.  Broadcasts, barriers and the
``mesh_all_reduce`` wrapper (whose per-axis reductions are recorded on
their own) have no HLO kind and are left out.

The estimated wire time is the JAX package's flat link model (bytes over
``link_gbps``): a scale for spotting a regression, not a measurement.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter",
                    "all-to-all", "collective-permute")

# the comms logger's op names -> the JAX digest's kinds
_KIND_OF = {"all_reduce": "all-reduce", "all_gather": "all-gather",
            "reduce_scatter": "reduce-scatter", "all_to_all": "all-to-all",
            "ppermute": "collective-permute"}


def digest_of(summary: Dict[str, Dict[str, float]],
              link_gbps: float = 45.0) -> Dict[str, Any]:
    """A comms-logger summary (``{op: {"count", "bytes", ...}}``) -> the
    JAX digest's dict: ``per_kind`` (the kinds that ran, each with
    ``count`` and ``bytes``), ``total_collectives``, ``total_bytes``,
    ``est_wire_ms`` and ``link_gbps_model``."""
    per_kind = {k: {"count": 0, "bytes": 0} for k in COLLECTIVE_KINDS}
    for op, s in summary.items():
        kind = _KIND_OF.get(op.split(":", 1)[0])
        if kind is None:
            continue
        per_kind[kind]["count"] += int(s["count"])
        per_kind[kind]["bytes"] += int(s["bytes"])
    total_bytes = sum(v["bytes"] for v in per_kind.values())
    return {
        "per_kind": {k: v for k, v in per_kind.items() if v["count"]},
        "total_collectives": sum(v["count"] for v in per_kind.values()),
        "total_bytes": total_bytes,
        "est_wire_ms": round(1e3 * total_bytes / (link_gbps * 1e9), 3),
        "link_gbps_model": link_gbps,
    }


def _minus(after: dict, before: dict) -> dict:
    out = {}
    for op, s in after.items():
        b = before.get(op, {"count": 0, "bytes": 0})
        n = s["count"] - b["count"]
        if n:
            out[op] = {"count": n, "bytes": s["bytes"] - b["bytes"]}
    return out


def dry_digest(run: Callable[[], Any], link_gbps: float = 45.0
               ) -> Dict[str, Any]:
    """The digest of the collectives ``run()`` (an engine's dry step)
    records: the logger's totals after it less those before, with the
    logger on for the call, so earlier records and the caller's own
    summary stay as they were."""
    from deepspeed_tpu_torch.comm import comms_logger

    log = comms_logger()
    was = log.enabled
    log.enabled = True
    before = log.summary()
    try:
        run()
    finally:
        after = log.summary()
        log.enabled = was
    return digest_of(_minus(after, before), link_gbps)


def log_digest(monitor, digest: Dict[str, Any], step: int,
               prefix: str = "Comms") -> None:
    """Write a digest's scalars through a
    :class:`~deepspeed_tpu_torch.monitor.MonitorMaster` (the JAX
    package's tags)."""
    scalars = {f"{prefix}/total_bytes": digest["total_bytes"],
               f"{prefix}/total_collectives": digest["total_collectives"],
               f"{prefix}/est_wire_ms": digest["est_wire_ms"]}
    for kind, v in digest["per_kind"].items():
        scalars[f"{prefix}/{kind}_bytes"] = v["bytes"]
        scalars[f"{prefix}/{kind}_count"] = v["count"]
    monitor.write_scalars(scalars, step)
