"""Metric monitoring backends (port of ``deepspeed_tpu/monitor.py``; ref:
deepspeed/monitor/*).

The reference ships tensorboard/wandb/csv writers behind a common
``Monitor`` interface driven by the config's ``tensorboard`` /
``wandb`` / ``csv_monitor`` blocks (ref: deepspeed/monitor/config.py,
monitor.py).  Same shape here: each backend implements
``write_events([(tag, value, step), ...])``; :class:`MonitorMaster`
fans out to every enabled backend, on process rank 0 only.  The
tensorboard and wandb backends disable themselves when their package is
absent, exactly as the JAX package's do.
"""

from __future__ import annotations

import csv
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

Event = Tuple[str, float, int]  # (tag, scalar, global_step)


class Monitor:
    enabled = True

    def write_events(self, events: Sequence[Event]) -> None:  # pragma: no cover
        raise NotImplementedError

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


class CsvMonitor(Monitor):
    """ref: deepspeed/monitor/csv_monitor.py — one csv file per tag."""

    def __init__(self, output_path: str = "ds_logs", job_name: str = "run"):
        self.dir = os.path.join(output_path, job_name)
        os.makedirs(self.dir, exist_ok=True)
        self._files: Dict[str, Any] = {}

    def _writer(self, tag: str):
        if tag not in self._files:
            safe = tag.replace("/", "_")
            f = open(os.path.join(self.dir, f"{safe}.csv"), "a", newline="")
            w = csv.writer(f)
            if f.tell() == 0:
                w.writerow(["step", tag])
            self._files[tag] = (f, w)
        return self._files[tag]

    def write_events(self, events: Sequence[Event]) -> None:
        for tag, value, step in events:
            f, w = self._writer(tag)
            w.writerow([step, float(value)])

    def flush(self) -> None:
        for f, _ in self._files.values():
            f.flush()

    def close(self) -> None:
        for f, _ in self._files.values():
            f.close()
        self._files.clear()


class TensorBoardMonitor(Monitor):
    """ref: deepspeed/monitor/tensorboard.py.  Gated on tensorboardX /

    torch.utils.tensorboard being importable; otherwise disabled."""

    def __init__(self, output_path: str = "ds_logs", job_name: str = "run"):
        self.enabled = False
        self._sw = None
        try:  # torch (cpu) is baked in; its tensorboard needs tensorboard pkg
            from torch.utils.tensorboard import SummaryWriter  # type: ignore

            self._sw = SummaryWriter(log_dir=os.path.join(output_path, job_name))
            self.enabled = True
        except Exception:
            pass

    def write_events(self, events: Sequence[Event]) -> None:
        if self._sw is None:
            return
        for tag, value, step in events:
            self._sw.add_scalar(tag, float(value), step)

    def flush(self) -> None:
        if self._sw is not None:
            self._sw.flush()

    def close(self) -> None:
        if self._sw is not None:
            self._sw.close()


class WandbMonitor(Monitor):
    """ref: deepspeed/monitor/wandb.py.  Gated on wandb being importable."""

    def __init__(self, project: Optional[str] = None, group: Optional[str] = None,
                 team: Optional[str] = None):
        self.enabled = False
        self._wandb = None
        try:
            import wandb  # type: ignore

            wandb.init(project=project, group=group, entity=team)
            self._wandb = wandb
            self.enabled = True
        except Exception:
            pass

    def write_events(self, events: Sequence[Event]) -> None:
        if self._wandb is None:
            return
        for tag, value, step in events:
            self._wandb.log({tag: float(value)}, step=step)

    def close(self) -> None:
        if self._wandb is not None:
            self._wandb.finish()


class CometMonitor(Monitor):
    """ref: deepspeed/monitor/comet.py.  Gated on comet_ml being
    importable (it is not baked into this image, so the backend is a
    no-op unless the user's environment provides it — same
    import-gating as wandb/tensorboard)."""

    def __init__(self, project: Optional[str] = None,
                 workspace: Optional[str] = None,
                 api_key: Optional[str] = None,
                 experiment_name: Optional[str] = None,
                 experiment_key: Optional[str] = None,
                 online: Optional[bool] = None,
                 mode: Optional[str] = None):
        self.enabled = False
        self._exp = None
        try:
            import comet_ml  # type: ignore

            exp = comet_ml.start(
                api_key=api_key, project=project, workspace=workspace,
                experiment_key=experiment_key,
                online=online,
                mode=mode or "get_or_create")
            try:
                if experiment_name:
                    exp.set_name(experiment_name)
            except Exception:
                # a started experiment must not leak its upload threads
                # when the backend ends up disabled
                exp.end()
                raise
            self._exp = exp
            self.enabled = True
        except Exception:
            pass

    def write_events(self, events: Sequence[Event]) -> None:
        if self._exp is None:
            return
        for tag, value, step in events:
            self._exp.log_metric(tag, float(value), step=step)

    def flush(self) -> None:
        if self._exp is not None:
            self._exp.flush()

    def close(self) -> None:
        if self._exp is not None:
            self._exp.end()


class MonitorMaster(Monitor):
    """Fan-out to all enabled backends, rank-0 only (ref: monitor/monitor.py

    ``MonitorMaster``).  Config keys match the reference:
    ``{"tensorboard": {"enabled": ..., "output_path": ..., "job_name": ...},
       "wandb": {...}, "csv_monitor": {...}}``.
    """

    def __init__(self, monitor_config: Optional[Dict[str, Any]] = None):
        from deepspeed_tpu_torch.utils.logging import process_rank

        self.rank0 = process_rank() == 0
        self.backends: List[Monitor] = []
        cfg = monitor_config or {}
        if not self.rank0:
            return
        tb = cfg.get("tensorboard", {})
        if tb.get("enabled"):
            m = TensorBoardMonitor(tb.get("output_path", "ds_logs"),
                                   tb.get("job_name", "run"))
            if m.enabled:
                self.backends.append(m)
        wb = cfg.get("wandb", {})
        if wb.get("enabled"):
            m = WandbMonitor(wb.get("project"), wb.get("group"), wb.get("team"))
            if m.enabled:
                self.backends.append(m)
        cm = cfg.get("csv_monitor", {})
        if cm.get("enabled"):
            self.backends.append(CsvMonitor(cm.get("output_path", "ds_logs"),
                                            cm.get("job_name", "run")))
        co = cfg.get("comet", {})
        if co.get("enabled"):
            m = CometMonitor(
                project=co.get("project"), workspace=co.get("workspace"),
                api_key=co.get("api_key"),
                experiment_name=co.get("experiment_name"),
                experiment_key=co.get("experiment_key"),
                online=co.get("online"), mode=co.get("mode"))
            if m.enabled:
                self.backends.append(m)

    @property
    def enabled(self) -> bool:  # type: ignore[override]
        return bool(self.backends)

    def write_events(self, events: Sequence[Event]) -> None:
        for b in self.backends:
            b.write_events(events)

    def write_scalars(self, scalars: Dict[str, float], step: int) -> None:
        self.write_events([(k, v, step) for k, v in scalars.items()])

    def flush(self) -> None:
        for b in self.backends:
            b.flush()

    def close(self) -> None:
        for b in self.backends:
            b.close()
